from omega_tpu_torch.core.config import (ModelConfig, TendencyConfig,
                                         ManufacturedConfig, VertMixConfig,
                                         model_config_from_yaml)
from omega_tpu_torch.core.state import ModelState, init_state
from omega_tpu_torch.core import aux, tendencies, eos, vert_coord, vmix
from omega_tpu_torch.core.tracers import (TracerSet, select_tracers,
                                          register_tracer_fields,
                                          TRACER_CATALOG)
from omega_tpu_torch.core.eos import (EosConfig, compute_spec_vol,
                                      teos10_specvol)
