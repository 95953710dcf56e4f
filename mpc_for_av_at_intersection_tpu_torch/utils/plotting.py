"""Visualization: offline from telemetry arrays, or live per tick.

Port of ``mpc_for_av_at_intersection_tpu/utils/plotting.py``: a copy of it
(numpy and matplotlib; ``tests/test_torch_live_viz.py`` pins the code to
the original) except ``primitive_fanout_trajectories``, which rolls the
fan-out with the port's ``core.dynamics.bicycle_rollout`` on ``device``.
The functions take numpy arrays: callers turn telemetry tensors into numpy
at the call (``tree_map(lambda t: t.cpu().numpy(), tel)``), and
``engine.run_episode_live`` hands ``LiveView`` numpy already.

Capability parity with reference ``main/lib/plotting.py`` (scenario/car/
search-point drawing), ``visualisation.py`` (animation factory) and the
drivers' final plots (speed/accel/deviation traces, time-colored trajectory
overlays — ``scenarios/mpc_intersection.py:177-271``). The production path
keeps rendering OUT of the control loop (the engine produces telemetry
arrays; figures are built afterwards); the reference's live frame-by-frame
animation (``mpc_intersection.py:150, 273-316``) is available through
``LiveView`` + ``engine.run_episode_live`` for interactive use.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..models import VehicleGeometry
from ..mpc.controller import CUDA
from ..worlds.obstacles import BoxObstacle, CircleObstacle
from ..worlds.scenario import Scenario


def draw_scenario(scenario: Scenario, ax, show_hidden: bool = False):
    """Obstacles (hidden ones dashed if requested), start arrow, goal area."""
    from matplotlib.patches import Circle, Rectangle

    for o in scenario.obstacles:
        if o.hidden and not show_hidden:
            continue
        style = dict(
            facecolor="lightgray" if not o.hidden else "none",
            edgecolor="gray",
            linestyle="--" if o.hidden else "-",
        )
        if isinstance(o, BoxObstacle):
            x1, y1, x2, y2 = o.corners
            ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, **style))
        elif isinstance(o, CircleObstacle):
            ax.add_patch(Circle(o.center, o.radius, **style))
    ga = scenario.goal_area
    x1, y1, x2, y2 = ga.corners
    ax.add_patch(
        Rectangle((x1, y1), x2 - x1, y2 - y1, facecolor="none", edgecolor="green")
    )
    draw_point_arrow(scenario.start, ax, color="tab:blue")
    draw_point_arrow(scenario.goal_point, ax, color="green")
    ax.set_aspect("equal")


def draw_point_arrow(pose, ax, color=None, length: float = 2.0):
    x, y, th = pose
    ax.arrow(
        x, y, length * math.cos(th), length * math.sin(th),
        head_width=0.6, color=color,
    )


def draw_car(pose, geom: VehicleGeometry, ax, color="k", steer: float = 0.0,
             draw_circles: bool = False):
    """Outline + wheels, rear-axle anchored (reference plotting.py:83-158)."""
    from matplotlib.patches import Circle

    x, y, th = pose[0], pose[1], pose[2]
    c, s = math.cos(th), math.sin(th)
    w, l = geom.width, geom.length
    cx_off, _ = geom.center_offset
    # body corners in the vehicle frame (rear overhang behind the rear axle)
    rear = cx_off - l / 2.0
    front = cx_off + l / 2.0
    pts = np.array(
        [[rear, -w / 2], [front, -w / 2], [front, w / 2], [rear, w / 2], [rear, -w / 2]]
    )
    world = np.stack([x + c * pts[:, 0] - s * pts[:, 1], y + s * pts[:, 0] + c * pts[:, 1]], axis=1)
    ax.plot(world[:, 0], world[:, 1], color=color)

    # wheels: rear pair straight, front pair rotated by the steer angle
    wl, hw = 0.7, w / 2.0 * 0.8
    for wx, steer_a in ((0.0, 0.0), (geom.wheelbase, steer)):
        for side in (-1, 1):
            cw, sw = math.cos(steer_a), math.sin(steer_a)
            wpts = np.array([[-wl / 2, 0.0], [wl / 2, 0.0]])
            wpts = wpts @ np.array([[cw, sw], [-sw, cw]])
            wpts += [wx, side * hw]
            wworld = np.stack(
                [x + c * wpts[:, 0] - s * wpts[:, 1], y + s * wpts[:, 0] + c * wpts[:, 1]],
                axis=1,
            )
            ax.plot(wworld[:, 0], wworld[:, 1], color=color, linewidth=2)

    if draw_circles:
        for ox, oy in geom.circle_centers:
            ax.add_patch(
                Circle(
                    (x + c * ox - s * oy, y + s * ox + c * oy),
                    geom.radius, fill=False, edgecolor=color, linestyle=":",
                )
            )


def draw_search_points(search, ax, visualize_heuristic: bool = True):
    """Visited lattice nodes colored by heuristic (reference
    plotting.py:161-179); requires the search ran with debug=True."""
    data = search.debug_data
    if not data:
        return
    xs = [e.node[0] for e in data]
    ys = [e.node[1] for e in data]
    cs = [e.h if visualize_heuristic else e.g for e in data]
    sc = ax.scatter(xs, ys, c=cs, s=4, cmap="viridis")
    return sc


def primitive_fanout_trajectories(
    num_mps: int = 5,
    angle_range_deg: float = 45.0,
    mp_time: float = 0.2,
    levels: int = 5,
    dt: float = 0.1,
    v: float = 1.0,
    wheelbase: float = 1.0,
    device=CUDA,
):
    """Recursive motion-primitive fan-out (the reference's pedagogical
    ``lib/generate_MPs_multiple.py:37`` / ``generate_MPs_single.py:15``
    demos — constant-velocity Euler bicycle arcs branched over a steering
    fan for ``levels`` generations). Level k rolls ALL num_mps^k frontier
    poses x num_mps steers as one batched ``bicycle_rollout`` on ``device``
    (the card unless the caller names the CPU), in float32.

    Returns a list of (n_steps+1, 3) numpy trajectories (root level first),
    ``levels=1``/wide fan reproduces the single-fan demo.
    """
    import torch

    from ..core.dynamics import bicycle_rollout

    deltas = torch.as_tensor(
        np.deg2rad(np.linspace(-angle_range_deg, angle_range_deg, num_mps)),
        dtype=torch.float32, device=device,
    )
    n_steps = max(int(round(mp_time / dt)), 1)

    out = []
    frontier = torch.zeros((1, 3), dtype=torch.float32, device=device)
    for _ in range(levels):
        P = frontier.shape[0]
        poses = frontier.repeat_interleave(num_mps, dim=0)     # (P*D, 3)
        ds = deltas.repeat(P)
        trajs = bicycle_rollout(poses, v, ds, dt, wheelbase, n_steps).transpose(0, 1)
        out.extend(trajs.cpu().numpy())                        # (P*D, n+1, 3)
        frontier = trajs[:, -1, :]
    return out


def plot_primitive_fanout(ax=None, linewidth: float = 0.2, **kwargs):
    """Draw the recursive primitive fan-out (reference demo parity plot)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 8))
    for traj in primitive_fanout_trajectories(**kwargs):
        ax.plot(traj[:, 0], traj[:, 1], linewidth=linewidth)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title("Bicycle Model Trajectories")
    ax.grid(True)
    ax.axis("equal")
    return ax


def plot_halfplane_region(halfplanes, ax, extent=(-45, 45, -45, 45), res=400):
    """Rasterize the region where ALL half-planes hold (debug tool; parity
    with reference ``envs/visualise_half_planes.py`` minus its bitrot)."""
    xs = np.linspace(extent[0], extent[1], res)
    ys = np.linspace(extent[2], extent[3], res)
    X, Y = np.meshgrid(xs, ys)
    hp = np.asarray(halfplanes)
    vals = hp[:, 0][:, None, None] * X[None] + hp[:, 1][:, None, None] * Y[None] + hp[:, 2][:, None, None]
    inside = np.all(vals <= 0.0, axis=0)
    ax.imshow(
        inside, origin="lower", extent=extent, alpha=0.4, cmap="Reds",
        interpolation="nearest",
    )
    ax.set_aspect("equal")
    return inside


def plot_telemetry(tel, dt: float = 0.2, axes=None, label: Optional[str] = None):
    """Speed / acceleration / reference-deviation traces
    (reference mpc_intersection.py:243-271)."""
    import matplotlib.pyplot as plt

    t = np.arange(len(np.asarray(tel.v))) * dt
    if axes is None:
        _, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
    axes[0].plot(t, np.asarray(tel.v) * 3.6, label=label)
    axes[0].set_ylabel("speed [km/h]")
    axes[1].plot(t, np.asarray(tel.accel), label=label)
    axes[1].set_ylabel("accel [m/s$^2$]")
    axes[2].plot(t, np.asarray(tel.xref_dev), label=label)
    axes[2].set_ylabel("deviation [m]")
    axes[2].set_xlabel("time [s]")
    for a in axes:
        a.grid(True)
        if label:
            a.legend()
    return axes


def plot_trajectories(tel, ax, dt: float = 0.2, agent_xy: Optional[np.ndarray] = None):
    """Time-colored ego (and agent) trajectory overlay
    (reference mpc_intersection.py:177-241)."""
    import matplotlib.pyplot as plt

    x = np.asarray(tel.x)
    y = np.asarray(tel.y)
    t = np.arange(len(x)) * dt
    sc = ax.scatter(x, y, c=t, cmap="viridis", s=14)
    if agent_xy is not None:
        for k in range(agent_xy.shape[1]):
            ax.scatter(agent_xy[:, k, 0], agent_xy[:, k, 1], c=t, cmap="viridis", s=6)
    plt.colorbar(sc, ax=ax, label="time [s]")
    ax.set_aspect("equal")
    return ax


def overlay_telemetry(records, dt: float = 0.2, trajectory=None, scenario=None):
    """Sweep-comparison figure family (reference
    ``mpc_sensitivity_analysis_comulative.py:268-438``: per swept parameter,
    overlaid trajectories + speed + acceleration + deviation across sweep
    values).

    ``records``: iterable of ``sweep.MPCSweepRecord`` (or any objects with
    ``.param``, ``.value``, ``.ticks_to_goal``, ``.telemetry``). Returns
    ``(fig, axes)`` with axes[0] the xy trajectory overlay and axes[1:4]
    the speed/accel/deviation traces, one labeled line per sweep value —
    the exact figure family behind ``main/results/mpc_sensitivity/*.pdf``.
    """
    import matplotlib.pyplot as plt

    records = list(records)
    fig, axes = plt.subplots(1, 4, figsize=(22, 5))
    line_styles = ["--", "-.", ":"]
    colors = ["b", "k", "r", "c", "m", "y", "g"]

    if scenario is not None:
        draw_scenario(scenario, axes[0])
    if trajectory is not None:
        traj = np.asarray(trajectory)
        axes[0].plot(traj[:, 0], traj[:, 1], color="0.8", lw=4,
                     label="reference path", zorder=0)

    for idx, rec in enumerate(records):
        tel = rec.telemetry
        k = int(rec.ticks_to_goal) or len(np.asarray(tel.v))
        label = f"{rec.param}={rec.value:g}"
        ls = line_styles[idx % len(line_styles)]
        color = colors[idx % len(colors)]
        t = np.arange(k) * dt
        axes[0].plot(np.asarray(tel.x)[:k], np.asarray(tel.y)[:k], ls,
                     color=color, label=label)
        axes[1].plot(t, np.asarray(tel.v)[:k] * 3.6, ls, color=color, label=label)
        axes[2].plot(t, np.asarray(tel.accel)[:k], ls, color=color, label=label)
        axes[3].plot(t, np.asarray(tel.xref_dev)[:k], ls, color=color, label=label)

    axes[0].set_aspect("equal")
    axes[0].set_xlabel("X [m]")
    axes[0].set_ylabel("Y [m]")
    axes[0].set_title("trajectories")
    for ax, name in zip(axes[1:], ("speed [km/h]", "accel [m/s$^2$]", "deviation [m]")):
        ax.set_xlabel("time [s]")
        ax.set_ylabel(name)
        ax.grid(color="lightgray", alpha=0.5)
    for ax in axes:
        ax.legend(fontsize=8)
    fig.tight_layout()
    return fig, axes


def animate_episode(
    scenario: Scenario, geom: VehicleGeometry, tel, dt: float = 0.2,
    agent_states: Optional[np.ndarray] = None, interval_ms: int = 50,
):
    """FuncAnimation factory over telemetry (reference visualisation.py:24-85).
    ``agent_states``: optional (T, n_agents, >=4) array of agent poses."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    fig, ax = plt.subplots(figsize=(8, 8))
    x = np.asarray(tel.x)
    y = np.asarray(tel.y)
    yaw = np.asarray(tel.yaw)

    def frame(k):
        ax.cla()
        draw_scenario(scenario, ax)
        ax.plot(x[: k + 1], y[: k + 1], "-r")
        draw_car((x[k], y[k], yaw[k]), geom, ax, color="k")
        if agent_states is not None:
            for j in range(agent_states.shape[1]):
                a = agent_states[k, j]
                draw_car((a[0], a[1], a[3]), geom, ax, color="tab:blue")
        ax.set_xlim(-45, 45)
        ax.set_ylim(-45, 45)
        ax.set_title(f"t = {k * dt:.1f} s")

    return FuncAnimation(fig, frame, frames=len(x), interval=interval_ms)


class LiveView:
    """Per-tick live renderer (reference ``visualize_frame``,
    ``mpc_intersection.py:273-316``): scenario + reference path + growing
    ego trail + ego/agent cars, redrawn every control tick.

    Use as the ``on_tick`` callback of ``engine.run_episode_live``. With a
    display, frames appear interactively (``plt.pause``, like the
    reference); with ``save_dir`` set, each frame is written as it is
    produced (``frame_0000.png``, ...) — still per-tick streaming, usable
    headless.
    """

    def __init__(self, scenario: Scenario, geom: VehicleGeometry,
                 trajectory=None, dt: float = 0.2,
                 extent=(-45.0, 45.0, -45.0, 45.0),
                 save_dir: Optional[str] = None, pause_s: float = 0.001):
        import matplotlib

        if save_dir is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.scenario = scenario
        self.geom = geom
        self.trajectory = None if trajectory is None else np.asarray(trajectory)
        self.dt = dt
        self.extent = extent
        self.save_dir = save_dir
        self.pause_s = pause_s
        self.trail_x: list = []
        self.trail_y: list = []
        self.fig, self.ax = plt.subplots(figsize=(8, 8))
        if save_dir is not None:
            import os

            os.makedirs(save_dir, exist_ok=True)
        elif hasattr(plt, "ion"):
            plt.ion()
            plt.show(block=False)

    def __call__(self, k, st, tel, agents6):
        ax = self.ax
        ax.cla()
        draw_scenario(self.scenario, ax)
        if self.trajectory is not None:
            ax.plot(self.trajectory[:, 0], self.trajectory[:, 1],
                    color="0.8", lw=3, zorder=0)
        self.trail_x.append(float(tel.x))
        self.trail_y.append(float(tel.y))
        ax.plot(self.trail_x, self.trail_y, "-r", lw=1.5)
        draw_car((float(tel.x), float(tel.y), float(tel.yaw)), self.geom, ax,
                 color="k", steer=float(tel.steer))
        for j in range(agents6.shape[0]):
            a = agents6[j]
            if a[2] != 0.0 or a[0] != 0.0 or a[1] != 0.0:
                draw_car((a[0], a[1], a[3]), self.geom, ax, color="tab:blue")
        ax.set_xlim(self.extent[0], self.extent[1])
        ax.set_ylim(self.extent[2], self.extent[3])
        ax.set_title(
            f"t = {k * self.dt:.1f} s   v = {float(tel.v) * 3.6:.1f} km/h"
        )
        if self.save_dir is not None:
            self.fig.savefig(f"{self.save_dir}/frame_{k:04d}.png", dpi=90)
        else:
            self.fig.canvas.draw_idle()
            self._plt.pause(self.pause_s)

    def close(self):
        self._plt.close(self.fig)
