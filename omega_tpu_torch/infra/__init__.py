from omega_tpu_torch.infra.time_manager import (
    Calendar,
    CalendarKind,
    TimeInstant,
    TimeInterval,
    TimeUnits,
    Alarm,
    Clock,
)
from omega_tpu_torch.infra.logging import get_logger, init_logging
from omega_tpu_torch.infra.timers import Timers, timer
from omega_tpu_torch.infra.errors import (OmegaError, ConfigError,
                                          FieldError, abort_error)
from omega_tpu_torch.infra.config import Config, default_config
from omega_tpu_torch.infra.dimension import Dimension, DimensionRegistry
from omega_tpu_torch.infra.field import Field, FieldRegistry, default_fields
