"""Sensitivity sweeps: MPC cost weights and planner search weights.

Port of ``mpc_for_av_at_intersection_tpu/sweep.py`` (capability parity with
the reference's sweep drivers):
- ``mpc_weight_sweep``     ~ ``scenarios/mpc_sensitivity_analysis_comulative.py``
  (which re-wrote a JSON config file between runs and re-imported the MPC —
  config-as-IPC; here a sweep is just a list of immutable MPCConfigs,
  QUIRKS #14)
- ``planner_weight_sweep`` ~ ``planner/Planner_Sensitivity_Heuristic.py`` /
  ``Planner_Sensitivity_TrueCost.py`` (itertools.product over heuristic /
  true-cost weights, recording runtime, search effort, and path shape)

The JAX version rebuilds its jitted episode for every weight. Here nothing
is rebuilt: K1 takes the cost weights as runtime arguments
(``ops/condense_qp.py::_consts``), so a sweep value costs one episode of
``engine.run_episode`` (K1 and K2 once a tick on the card). The device is
the one ``setup_builder`` puts its tensors on (the card unless it names the
CPU).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Sequence

import numpy as np

from .engine import EngineConfig, run_episode
from .engine.closed_loop import tree_map
from .lattice import MotionPrimitiveSearch, SearchWeights, primitive_table
from .models import VehicleGeometry
from .mpc import MPCConfig


@dataclasses.dataclass
class MPCSweepRecord:
    param: str
    value: float
    ticks_to_goal: int
    done: bool
    telemetry: object
    max_deviation: float
    mean_abs_accel: float


def mpc_weight_sweep(
    setup_builder,
    param: str,
    values: Sequence[float],
    n_steps: int = 256,
) -> List[MPCSweepRecord]:
    """Re-run a driver with one MPC weight swept over ``values``.

    ``setup_builder(cfg)`` must return a DriverSetup given an EngineConfig
    (e.g. ``lambda cfg: api.build_intersection(cfg=cfg)``). Each record's
    telemetry is numpy.
    """
    out = []
    for v in values:
        base = EngineConfig()
        mpc_cfg = dataclasses.replace(MPCConfig.canonical(), **{param: v})
        cfg = dataclasses.replace(base, mpc=mpc_cfg)
        setup = setup_builder(cfg)
        final, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, n_steps)
        tel_np = tree_map(lambda t: t.cpu().numpy(), tel)
        k = int(final.ticks_to_goal)
        dev = np.asarray(tel_np.xref_dev)[:k]
        acc = np.asarray(tel_np.accel)[:k]
        out.append(
            MPCSweepRecord(
                param=param,
                value=float(v),
                ticks_to_goal=k,
                done=bool(final.done),
                telemetry=tel_np,
                max_deviation=float(dev.max()) if k else float("nan"),
                mean_abs_accel=float(np.abs(acc).mean()) if k else float("nan"),
            )
        )
    return out


@dataclasses.dataclass
class PlannerSweepRecord:
    weights: Dict[str, float]
    cost: float
    n_expanded: int
    runtime_s: float
    path_len: int
    trajectory: np.ndarray


def planner_weight_sweep(
    scenario,
    geom: VehicleGeometry,
    weight_grid: Dict[str, Sequence[float]],
    base: SearchWeights = SearchWeights.multi_lane(),
) -> List[PlannerSweepRecord]:
    """Cartesian sweep over lattice-search weights (heuristic and/or true
    cost), recording optimality / effort / runtime trade-offs. Host code:
    the Python lattice search, as in the JAX package."""
    table = primitive_table(geom)
    keys = list(weight_grid)
    out = []
    for combo in itertools.product(*(weight_grid[k] for k in keys)):
        weights = dataclasses.replace(base, **dict(zip(keys, combo)))
        search = MotionPrimitiveSearch(
            scenario, geom, table, margin=geom.radius, weights=weights
        )
        t0 = time.perf_counter()
        cost, path, trajectory = search.run(debug=True)
        rt = time.perf_counter() - t0
        out.append(
            PlannerSweepRecord(
                weights=dict(zip(keys, combo)),
                cost=float(cost),
                n_expanded=len(search.debug_data),
                runtime_s=rt,
                path_len=len(path),
                trajectory=trajectory,
            )
        )
    return out
