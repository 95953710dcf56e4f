"""The MPC controller. The batched tick is ``mpc.batch.mpc_step_batched``
(not imported here: it imports ``ops``, whose plain versions import this
package's modules); ``mpc_step`` runs it on one scenario."""

from .config import MPCConfig
from .controller import (
    ControllerState,
    MPCStepOut,
    controller_state_from_numpy,
    controller_state_to_numpy,
    init_controller_state,
    is_goal,
    mpc_step,
    xref_deviation,
)

__all__ = [
    "MPCConfig",
    "ControllerState",
    "MPCStepOut",
    "controller_state_from_numpy",
    "controller_state_to_numpy",
    "init_controller_state",
    "is_goal",
    "mpc_step",
    "xref_deviation",
]
