"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with its
plain PyTorch version beside it: ``condense_qp`` (K1), ``admm`` (K2, A/B-1,
A/B-2), ``admm_probes`` (the profile path's Probe-1/2/3), ``astar`` (K3)
and ``collision`` (K4); and ``scan``, the conflict scan's first hit, whose
plain version is ``agents/collision.py``'s."""

from .admm_probes import admm_iterations
from .collision import (
    PackedCollision,
    frontier_collision,
    frontier_collision_reference,
    pack_collision,
)

__all__ = ["PackedCollision", "admm_iterations", "frontier_collision",
           "frontier_collision_reference", "pack_collision"]
