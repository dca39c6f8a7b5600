from repro_torch.core.movement.collectives import (
    chunked_all_gather,
    compressed_all_gather,
    compressed_grad_sync,
)
from repro_torch.core.movement.daemon_step import (
    DaemonState,
    init_state,
    init_working_copy,
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
    "chunked_all_gather", "compressed_all_gather", "compressed_grad_sync",
    "DaemonState", "init_state", "init_working_copy", "make_daemon_train_step",
    "working_copy",
    "BASELINE", "DAEMON_AGGRESSIVE", "DAEMON_DEFAULT", "MovementConfig",
    "SelectionUnit",
]
