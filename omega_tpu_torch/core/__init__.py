from omega_tpu_torch.core.config import (ModelConfig, TendencyConfig,
                                         ManufacturedConfig, VertMixConfig)
from omega_tpu_torch.core.state import ModelState, init_state
from omega_tpu_torch.core import aux, tendencies
