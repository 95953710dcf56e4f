"""The one generator of the benchmark's traffic: it reads a traffic file's
parameters and builds, from the seed, the fleet the program runs (its
world, its start state and its tick), through the program's own builders.

The traffic file's ``kind`` names the module ``kinds/<kind>.py`` that
draws that kind of fleet and lays its rows out for the check; a new kind
is a new file there. An episode is ``episode_ticks`` ticks from the start
state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from . import spec


@dataclasses.dataclass
class Fleet:
    kind: str
    tick: Callable          # state -> (state, Telemetry)
    world: object
    state0: object
    cfg: object
    geom: object
    rows: int               # ego rows a tick advances
    episode_ticks: int


def engine_config(config: dict, traffic: dict):
    """The program's ``EngineConfig`` as the configuration file states it;
    the traffic sets the number of scripted-agent slots."""
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig

    mpc = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config["mpc"].items()}
    return EngineConfig(mpc=MPCConfig(**mpc), n_agents=traffic["agent_slots"],
                        **config["engine"])


def build(traffic: dict, config: dict, seed: int, device) -> Fleet:
    cfg = engine_config(config, traffic)
    rng = np.random.default_rng(seed)
    geom, world, state0, tick, rows = spec.kind(traffic["kind"]).build(traffic, cfg, rng, device)
    _check_vehicle(geom, config["vehicle"])
    return Fleet(traffic["kind"], tick, world, state0, cfg, geom, rows,
                 traffic["episode_ticks"])


def _check_vehicle(geom, vehicle):
    """The program's vehicle has to be the configuration's."""
    got = {"wheelbase": geom.wheelbase, "width": geom.width, "length": geom.length}
    if any(abs(got[k] - vehicle[k]) > 1e-12 for k in got):
        raise ValueError(f"the program's vehicle {got} is not the configuration's {vehicle}")
