"""Generic lazy-expansion A* over hashable nodes (host-side oracle).

A copy of ``mpc_for_av_at_intersection_tpu/lattice/astar.py`` (numpy only), so
that the port loads nothing of the JAX package;
``tests/test_torch_worlds_lattice.py`` pins it to the original.

Contract parity with reference ``main/lib/a_star.py``: binary heap of
(f, g, node, predecessor) tuples (so cost ties break on node ordering the
same way), lazy duplicate skipping via a best-predecessor dict, optional
debug trace of every expansion, and an exception on frontier exhaustion.
This is the exact-search oracle; the batched device wavefront search in
``wavefront.py`` trades expansion order for lockstep parallelism and is
validated against this.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Generic, Hashable, Iterable, List, NamedTuple, Tuple, TypeVar

TNode = TypeVar("TNode", bound=Hashable)


class Expansion(NamedTuple):
    g: float
    h: float
    node: object
    predecessor: object


class NoPathError(RuntimeError):
    pass


class AStar(Generic[TNode]):
    def __init__(self, neighbor_function: Callable[[TNode], Iterable[Tuple[float, TNode]]]):
        self.neighbor_function = neighbor_function
        self.debug_data: List[Expansion] = []

    def run(
        self,
        start: TNode,
        is_goal_function: Callable[[TNode], bool],
        heuristic_function: Callable[[TNode], float],
        debug: bool = False,
    ) -> Tuple[float, List[TNode]]:
        frontier: List[Tuple[float, float, TNode, TNode]] = [(0.0, 0.0, start, start)]
        best: Dict[TNode, Tuple[float, TNode]] = {}
        if debug:
            self.debug_data = []

        while frontier:
            f, g, node, pred = heapq.heappop(frontier)
            if node in best and g >= best[node][0]:
                continue
            best[node] = (g, pred)
            if debug:
                self.debug_data.append(Expansion(g=g, h=f - g, node=node, predecessor=pred))

            if is_goal_function(node):
                path = [node]
                while node != start:
                    path.append(pred)
                    node, pred = pred, best[pred][1]
                path.reverse()
                return g, path

            for edge_cost, nbr in self.neighbor_function(node):
                ng = g + edge_cost
                if nbr not in best or ng < best[nbr][0]:
                    heapq.heappush(
                        frontier, (ng + heuristic_function(nbr), ng, nbr, node)
                    )

        raise NoPathError("no path to goal")
