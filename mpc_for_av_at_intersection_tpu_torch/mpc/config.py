"""MPC configuration.

A copy of ``mpc_for_av_at_intersection_tpu/mpc/config.py``: that module is
JAX-free, but its package ``__init__`` imports the JAX controller, so the
port carries its own. ``tests/test_torch_port_imports.py`` pins every
field, default and factory to the JAX one.

Replaces the reference's cwd-relative JSON + per-variant hard-coded module
constants (``main/lib/mpc.py:13-36``, ``mpc_with_speed.py:16-40``,
``mpc_jerk.py:16-40``) with one typed, immutable config. The three reference
controller variants are factory methods; ``from_json`` still reads the
reference's ``mpc_config.json`` schema for drop-in compatibility.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    # dimensions / discretization
    T: int = 13                  # horizon length
    dt: float = 0.2

    # tracking cost (anisotropic xy + v/yaw), reference mpc.py:156-170
    w_perp: float = 20.0         # perpendicular-to-reference weight
    w_para: float = 1.0          # along-reference weight
    q_v: float = 0.0
    q_yaw: float = 0.5
    qf: Tuple[float, float, float, float] = (1.0, 1.0, 0.0, 0.5)  # x T at end
    end_input_weight: float = 10.0  # input cost once the ref end is reached

    # input / input-rate cost
    r_accel: float = 0.01
    r_steer: float = 0.01
    rd_accel: float = 0.01
    rd_steer: float = 1.0

    # limits (mpc_config.json + Simulation constants)
    max_accel: float = 2.0
    max_decel: float = -10.0
    max_dsteer: float = math.radians(30.0)
    max_steer: float = math.radians(45.0)
    max_speed: float = 30.0 / 3.6
    min_speed: float = -5.0

    # goal test (mpc.py:310-326)
    goal_dist: float = 1.5
    stop_speed: float = 0.1389

    max_iter: int = 1            # re-linearization iterations

    # --- variant switches ---
    # speed-reference yielding (mpc_with_speed.py): track a velocity channel
    # that is `target_speed` along the path and 0 beyond the conflict cutoff
    speed_ref: bool = False
    target_speed: float = 25.0 / 3.6
    # comfort variant (mpc_jerk.py): extra accel state + jerk penalty
    jerk: bool = False
    jerk_weight: float = 1.0

    # solver controls. With ``admm_eps > 0`` (the default) the solver runs
    # up to ``admm_max_checks`` blocks of ``admm_check_iters`` iterations,
    # exits early once the relative primal AND dual residuals drop below
    # ``admm_eps``, refactorizes only when rho drifts outside
    # ``[1/band, band]`` (OSQP's direct-solver rho policy), and warm-starts
    # each control tick from the previous tick's (x, y, rho) carried in
    # ``ControllerState`` (reference intent: ``main/lib/mpc.py:222-224``,
    # which warm-starts the linearization controls the same way). Cold
    # budget 16 x 32 = 512 iterations ~= the round-4 fixed 3 x 170.
    admm_eps: float = 1e-4       # relative residual tolerance (0 = fixed)
    admm_check_iters: int = 32   # iterations per residual check block
    admm_max_checks: int = 16    # max check blocks (cap = checks * iters)
    admm_refactor_band: float = 5.0  # rho drift band before refactorizing
    # stall exit: a lane that is near-converged (score <= cap) but no
    # longer improving by 1/ratio per block stops early and hands off to
    # the polish — ~10% of fp32 instances noise-floor above admm_eps and
    # would otherwise pin their whole 128-lane group at the check cap
    admm_stall_cap: float = 1e-3
    admm_stall_ratio: float = 0.5
    warm_start_qp: bool = True   # carry (x, y, rho) across control ticks
    # legacy fixed-budget knobs, used when ``admm_eps == 0`` (3 x 170
    # matches 10 x 50 accuracy on the adversarial oracle instances while
    # cutting factorizations 3x)
    admm_rounds: int = 3         # outer rounds (refactorize + adapt rho)
    admm_iters: int = 170        # inner iterations per round
    admm_rho: float = 0.1
    admm_sigma: float = 1e-6
    admm_alpha: float = 1.6
    # Ruiz equilibration passes per solve. 3 measures ~2.3 ms faster than
    # 10 at B=4096 with slightly BETTER warm convergence/polish acceptance
    # (the modified-Ruiz recurrence converges in a few passes on these
    # instances); quality gates (f64 oracle, 131k failure tail) re-run at 3
    admm_ruiz_iters: int = 3
    polish: bool = True

    @property
    def solver_schedule(self):
        """(max_checks, check_iters, eps, band, stall_cap, stall_ratio)
        for the adaptive solver — collapses to the legacy fixed budget
        when ``admm_eps == 0``."""
        if self.admm_eps > 0.0:
            return (self.admm_max_checks, self.admm_check_iters,
                    self.admm_eps, self.admm_refactor_band,
                    self.admm_stall_cap, self.admm_stall_ratio)
        return (self.admm_rounds, self.admm_iters, 0.0, 0.0, 0.0, 0.5)

    @property
    def qp_dims(self):
        """(n, m) of the condensed box-QP for this variant."""
        n = 2 * self.T + 1 if self.jerk else 2 * self.T
        return n, 4 * self.T - 1

    @property
    def nx(self) -> int:
        return 5 if self.jerk else 4

    @property
    def nu(self) -> int:
        return 2

    @staticmethod
    def canonical() -> "MPCConfig":
        """The flagship controller (reference ``mpc.py`` + mpc_config.json)."""
        return MPCConfig()

    @staticmethod
    def with_speed_ref() -> "MPCConfig":
        """Yield-by-slowing variant (reference ``mpc_with_speed.py:16-40``)."""
        return MPCConfig(
            speed_ref=True,
            w_perp=10.0,
            q_v=20.0,
            max_decel=-5.0,
            target_speed=25.0 / 3.6,
        )

    @staticmethod
    def with_jerk() -> "MPCConfig":
        """Comfort variant (reference ``mpc_jerk.py:16-40``, cost loop
        :160-190: w_perp hard-coded to 10, Rd=(0.3, 1), MAX_DECEL=-5,
        STOP_SPEED=0.5/3.6, jerk penalty weight 1)."""
        return MPCConfig(
            jerk=True,
            w_perp=10.0,
            rd_accel=0.3,
            max_decel=-5.0,
            stop_speed=0.5 / 3.6,
        )

    @staticmethod
    def from_json(path: str, **overrides) -> "MPCConfig":
        """Read the reference ``mpc_config.json`` schema."""
        with open(path) as f:
            c = json.load(f)
        kw = dict(
            T=int(c["T"]),
            w_perp=float(c["w_perp"]),
            w_para=float(c["w_para"]),
            r_accel=float(c["R"][0]),
            r_steer=float(c["R"][1]),
            rd_accel=float(c["Rd"][0]),
            rd_steer=float(c["Rd"][1]),
            q_v=float(c["Q_v_yaw"][0]),
            q_yaw=float(c["Q_v_yaw"][1]),
            qf=tuple(float(v) for v in c["Qf"]),
            goal_dist=float(c["GOAL_DIS"]),
            stop_speed=float(c["STOP_SPEED"]),
            max_iter=int(c["MAX_ITER"]),
            max_dsteer=math.radians(float(c["MAX_DSTEER"])),
            max_accel=float(c["MAX_ACCEL"]),
            max_decel=float(c["MAX_DECEL"]),
        )
        kw.update(overrides)
        return MPCConfig(**kw)
