from repro_torch.core.movement.daemon_step import (
    DaemonState,
    init_state,
    make_daemon_train_step,
    working_copy,
)
from repro_torch.core.movement.engine import (
    BASELINE,
    DAEMON_AGGRESSIVE,
    DAEMON_DEFAULT,
    MovementConfig,
    SelectionUnit,
)

__all__ = [
    "DaemonState", "init_state", "make_daemon_train_step", "working_copy",
    "BASELINE", "DAEMON_AGGRESSIVE", "DAEMON_DEFAULT", "MovementConfig",
    "SelectionUnit",
]
