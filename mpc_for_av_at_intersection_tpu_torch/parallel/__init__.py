from .mesh import (
    batch_mesh,
    host_chip_mesh,
    run_batch_episodes,
    stack_states,
    stack_worlds,
)

__all__ = [
    "batch_mesh",
    "host_chip_mesh",
    "run_batch_episodes",
    "stack_worlds",
    "stack_states",
]
