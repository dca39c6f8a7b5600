from repro_torch.core.movement.daemon_step import working_copy
from repro_torch.core.movement.engine import (
    BASELINE,
    DAEMON_AGGRESSIVE,
    DAEMON_DEFAULT,
    MovementConfig,
    SelectionUnit,
)

__all__ = [
    "working_copy",
    "BASELINE", "DAEMON_AGGRESSIVE", "DAEMON_DEFAULT", "MovementConfig",
    "SelectionUnit",
]
