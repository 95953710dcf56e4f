"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with its
plain PyTorch version beside it: ``condense_qp`` (K1), ``admm`` (K2),
``astar`` (K3) and ``collision`` (K4)."""

from .collision import (
    PackedCollision,
    frontier_collision,
    frontier_collision_reference,
    pack_collision,
)

__all__ = ["PackedCollision", "frontier_collision", "frontier_collision_reference",
           "pack_collision"]
