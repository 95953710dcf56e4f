"""PyTorch port: the outcome checks of ``tests/test_drivers.py`` on the port's
drivers, on the CPU (``device="cpu"``: the plain versions of K1 and K2).

The roundabout driver at the reference's exact setup (big geometry,
U-turn, 960-point course, 320 ticks), the overtaking-cyclist driver (100 m
arterial, ``n_traj=2048``) and the basic T-intersection at its first and
ninth canned setups: each ego reaches its goal within 1.6 m and stops
there, every tick's QP solved, the steering inside its box.
"""

import numpy as np
import pytest
import torch

from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.engine import run_episode

torch.set_num_threads(2)


def _finished(setup, n_steps, goal_tol=1.6):
    final, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, n_steps)
    assert tel.x.shape == (n_steps,)
    assert bool(final.done), f"not done; end pos {final.ego[:2].tolist()}"
    k = int(final.ticks_to_goal)
    goal = setup.trajectory[-1, :2]
    assert np.hypot(float(tel.x[k - 1]) - goal[0], float(tel.y[k - 1]) - goal[1]) < goal_tol
    assert bool(tel.solved.all())
    assert float(tel.steer[:k].abs().max()) <= np.radians(45) + 1e-4
    # frozen once done: the last ticks repeat the pose of the goal tick
    assert float(tel.x[-1]) == float(tel.x[k - 1]) and bool(tel.done[k:].all())
    return final, tel


def test_roundabout_driver_reference_config():
    setup = api.build_roundabout(device="cpu")   # defaults == reference driver config
    assert len(setup.trajectory) == 960          # reference search: 960 pts, U-turn
    _finished(setup, 320)


def test_overtaking_cyclist_driver():
    setup = api.build_overtaking_cyclist(device="cpu")
    assert setup.cfg.n_traj == 2048 and setup.world.course.shape == (2048, 3)
    _finished(setup, 256)


@pytest.mark.parametrize("scenario_no", [1, 9])
def test_t_intersection_basic(scenario_no):
    setup = api.build_t_intersection_basic(scenario_no=scenario_no, device="cpu")
    _, tel = _finished(setup, 256)
    if scenario_no == 1:
        assert not bool(tel.collision_found.any())   # no traffic in this setup
