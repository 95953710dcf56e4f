from .mesh import run_batch_episodes, stack_states, stack_worlds

__all__ = ["run_batch_episodes", "stack_states", "stack_worlds"]
