"""Headless twin of the reference's interactive grid-A* teaching toy.

Port of ``mpc_for_av_at_intersection_tpu/utils/grid_astar_demo.py``: a copy
of it over the port's ``lattice.astar`` (host code; ``tests/test_torch_live_viz.py``
pins the code to the original).

The reference ships a 342-line tkinter click-the-grid demo
(``main/planner/A_star_naive.py``): a 25x25 board, 8-connected
unit-weight moves (diagonals cost 1 too), Manhattan heuristic, explored
cells and the recovered path painted on the buttons. tkinter has no place
in a headless framework, so this twin keeps the exact search semantics
— driven through the framework's generic ``lattice.astar.AStar`` oracle —
and renders the same three layers (obstacles, explored set, path) as
either an ASCII board or a matplotlib figure.

Run: ``python -m mpc_for_av_at_intersection_tpu_torch.utils.grid_astar_demo``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from ..lattice.astar import AStar, NoPathError

GRID = 25
_MOVES = (
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (-1, 1), (-1, -1), (1, -1),
)


def grid_astar(
    start: Tuple[int, int],
    goal: Tuple[int, int],
    obstacles: Iterable[Tuple[int, int]] = (),
    size: int = GRID,
):
    """25x25 8-connected unit-cost A* with the toy's Manhattan heuristic.

    Returns (path, explored): the start->goal cell path and the list of
    expanded cells in expansion order (the cells the GUI paints yellow).
    Raises ``NoPathError`` when walled off, where the GUI just stalls.
    """
    obs = {tuple(o) for o in obstacles}

    def neighbors(cell):
        r, c = cell
        for dr, dc in _MOVES:
            n = (r + dr, c + dc)
            # every edge weighs 1 — including diagonals (the toy's quirk;
            # A_star_naive.py:285 "The weight of every edge is 1")
            if 0 <= n[0] < size and 0 <= n[1] < size and n not in obs:
                yield 1.0, n

    search: AStar = AStar(neighbors)
    _, path = search.run(
        tuple(start),
        is_goal_function=lambda n: n == tuple(goal),
        heuristic_function=lambda n: abs(n[0] - goal[0]) + abs(n[1] - goal[1]),
        debug=True,
    )
    explored = [e.node for e in search.debug_data]
    return path, explored


def render_ascii(
    start, goal, obstacles=(), path: Optional[Sequence] = None,
    explored: Optional[Sequence] = None, size: int = GRID,
) -> str:
    """Board string: S/G endpoints, # obstacles, * path, . explored."""
    board: List[List[str]] = [[" "] * size for _ in range(size)]
    for (r, c) in explored or ():
        board[r][c] = "."
    for (r, c) in path or ():
        board[r][c] = "*"
    for (r, c) in obstacles:
        board[r][c] = "#"
    board[start[0]][start[1]] = "S"
    board[goal[0]][goal[1]] = "G"
    edge = "+" + "-" * size + "+"
    return "\n".join([edge] + ["|" + "".join(row) + "|" for row in board] + [edge])


def plot_grid_astar(start, goal, obstacles=(), ax=None, size: int = GRID):
    """Matplotlib rendering with the GUI's color language (obstacles black,
    explored yellow, path red, endpoints green/blue)."""
    import numpy as np
    import matplotlib.pyplot as plt

    path, explored = grid_astar(start, goal, obstacles, size)
    img = np.ones((size, size, 3))
    for (r, c) in explored:
        img[r, c] = (1.0, 1.0, 0.6)
    for (r, c) in path:
        img[r, c] = (0.9, 0.2, 0.2)
    for (r, c) in obstacles:
        img[r, c] = (0.0, 0.0, 0.0)
    img[start[0]][start[1]] = (0.2, 0.8, 0.2)
    img[goal[0]][goal[1]] = (0.2, 0.4, 0.9)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(img, origin="upper")
    ax.set_title("grid A* (reference A_star_naive.py twin)")
    ax.set_xticks([])
    ax.set_yticks([])
    return ax, path, explored


def main():
    start, goal = (2, 2), (20, 21)
    wall = [(r, 12) for r in range(3, 22)]
    try:
        path, explored = grid_astar(start, goal, wall)
    except NoPathError:
        print("no path")
        return
    print(render_ascii(start, goal, wall, path, explored))
    print(f"path length {len(path)}, {len(explored)} cells expanded")


if __name__ == "__main__":
    main()
