"""Error handling — the infra/Error.h analogue.

The reference accumulates severities and aborts through MPI_Abort with a
cpptrace stack trace (infra/Error.h:28-89). Here errors are exceptions with
the standard traceback; `abort_error` logs critical and raises.
"""

from __future__ import annotations

from omega_tpu_torch.infra.logging import get_logger


class OmegaError(RuntimeError):
    pass


class ConfigError(OmegaError):
    """Missing or mistyped configuration entry (infra/Config.h error codes)."""


class FieldError(OmegaError):
    """Unknown field / dimension / group, or metadata mismatch."""


class IOError_(OmegaError):
    """File / stream error (base/IO.h, infra/IOStream.h error paths)."""


def abort_error(msg: str, *args) -> None:
    text = msg.format(*args) if args else msg
    get_logger().critical(text)
    raise OmegaError(text)


def check_error_abort(condition: bool, msg: str, *args) -> None:
    if not condition:
        abort_error(msg, *args)
