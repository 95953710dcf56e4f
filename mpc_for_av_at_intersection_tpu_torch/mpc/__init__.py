"""The batched MPC controller. The tick itself is ``mpc.batch.mpc_step_batched``
(not imported here: it imports ``ops``, whose plain versions import this
package's modules)."""

from .config import MPCConfig
from .controller import (
    ControllerState,
    MPCStepOut,
    controller_state_from_numpy,
    controller_state_to_numpy,
    init_controller_state,
)

__all__ = [
    "MPCConfig",
    "ControllerState",
    "MPCStepOut",
    "controller_state_from_numpy",
    "controller_state_to_numpy",
    "init_controller_state",
]
