"""PyTorch port: import guard, configuration parity and kernel dispatch.

- A subprocess in which ``import jax`` fails imports every module of the
  port and runs one CPU tick (B=4, T=13): the port never imports JAX, at
  any depth, so it runs on a machine without it.
- The port's copies of ``MPCConfig`` and the vehicle geometry equal the
  JAX package's field for field (``MPCConfig`` for the defaults, every
  factory and ``from_json``, with the same properties).
- On CPU tensors the kernel wrappers run their plain versions and count no
  launch; a tensor on any other device goes to the kernel path, which
  checks it before anything is built, so it never reaches a plain version.
"""

import dataclasses
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpc_for_av_at_intersection_tpu_torch as port
from mpc_for_av_at_intersection_tpu.mpc.config import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.ops import condense_qp
from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent

_NO_JAX_TICK = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import numpy as np, torch
torch.set_num_threads(1)
import mpc_for_av_at_intersection_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules if sys.modules[k] is not None)
from mpc_for_av_at_intersection_tpu_torch.core import smooth_yaw_numpy
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp
rng = np.random.default_rng(0)
B, N, dl = 4, 120, 0.083
yaw = rng.uniform(-np.pi, np.pi, (B, 1)) + rng.normal(0, 0.01, (B, N)).cumsum(1)
xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], -1) * dl, 1)
course = np.concatenate([xy, np.stack([smooth_yaw_numpy(y) for y in yaw])[..., None]], -1)
states = np.stack([course[:, 5, 0], course[:, 5, 1], np.full(B, 4.0), course[:, 5, 2]], 1)
cfg = MPCConfig(T=13)
out = mpc_step_batched(torch.tensor(states, dtype=torch.float32),
                       torch.tensor(course, dtype=torch.float32), torch.zeros(B, N),
                       torch.full((B,), N, dtype=torch.int32), torch.full((B,), dl),
                       init_controller_state(cfg, batch=B), cfg, bicycle_geometry().wheelbase)
assert out.accel.shape == (B,) and bool(out.solved.all()), out.solved
assert bool(torch.isfinite(out.plan_xy).all())
assert build_qp.launches == 0 and solve_box_qp_fused.launches == 0
print("modules", len(names))
"""


def test_port_imports_and_ticks_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_TICK], cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 15


def test_no_port_source_names_jax():
    """A second guard for code paths the tick does not take."""
    pattern = re.compile(r"^\s*(import jax|from jax|import mpc_for_av_at_intersection_tpu\b"
                         r"|from mpc_for_av_at_intersection_tpu[ .])", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT_DIR.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_every_port_module_is_listed():
    names = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
    for sub in ("core.angles", "core.curves", "core.dynamics", "models.vehicle", "mpc.batch",
                "mpc.condense", "mpc.config", "mpc.controller", "mpc.linearize", "mpc.qp",
                "mpc.reference", "ops.admm", "ops.condense_qp", "ops._build"):
        assert f"{port.__name__}.{sub}" in names


@pytest.mark.parametrize("factory", ["default", "canonical", "with_speed_ref", "with_jerk"])
def test_mpc_config_matches_jax(factory):
    if factory == "default":
        ours, theirs = MPCConfig(), JaxMPCConfig()
    else:
        ours, theirs = getattr(MPCConfig, factory)(), getattr(JaxMPCConfig, factory)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("solver_schedule", "qp_dims", "nx", "nu"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert [f.name for f in dataclasses.fields(MPCConfig)] == [
        f.name for f in dataclasses.fields(JaxMPCConfig)]
    assert MPCConfig(T=20, admm_eps=0.0).solver_schedule == JaxMPCConfig(
        T=20, admm_eps=0.0).solver_schedule


def test_mpc_config_from_json_matches_jax(tmp_path):
    path = tmp_path / "mpc_config.json"
    path.write_text(json.dumps({
        "T": 20, "w_perp": 15.0, "w_para": 2.0, "R": [0.02, 0.03], "Rd": [0.1, 2.0],
        "Q_v_yaw": [0.5, 0.7], "Qf": [1.0, 2.0, 0.0, 0.5], "GOAL_DIS": 2.0,
        "STOP_SPEED": 0.2, "MAX_ITER": 2, "MAX_DSTEER": 25.0, "MAX_ACCEL": 1.5,
        "MAX_DECEL": -6.0}))
    ours = MPCConfig.from_json(str(path), polish=True)
    theirs = JaxMPCConfig.from_json(str(path), polish=True)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_cpu_tensors_count_no_kernel_launch():
    cfg = MPCConfig(T=13)
    B, N = 3, 60
    t = torch.linspace(0, 5, N)
    course = torch.stack([t, torch.zeros(N), torch.zeros(N)], -1).expand(B, N, 3).contiguous()
    states = torch.tensor([[0.2, 0.1, 3.0, 0.0]]).expand(B, 4).contiguous()
    before = (build_qp.launches, solve_box_qp_fused.launches)
    out = mpc_step_batched(states, course, torch.zeros(B, N), torch.full((B,), N, dtype=torch.int32),
                           torch.full((B,), 5.0 / (N - 1)), init_controller_state(cfg, batch=B),
                           cfg, bicycle_geometry().wheelbase)
    assert bool(out.solved.all())
    assert (build_qp.launches, solve_box_qp_fused.launches) == before == (0, 0)


def test_non_cpu_tensors_never_reach_the_plain_version():
    """``meta`` tensors stand in for CUDA ones: the wrappers take the kernel
    path and refuse them there, before building or launching anything."""
    cfg = MPCConfig(T=13)
    T, B = cfg.T, 2
    n, m = cfg.qp_dims
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        build_qp(torch.empty(B, 4, **meta), torch.empty(B, T, **meta), torch.empty(B, T, **meta),
                 torch.empty(B, 4, T + 1, **meta), torch.empty(B, T + 1, dtype=torch.bool, **meta),
                 cfg, bicycle_geometry().wheelbase)
    with pytest.raises(ValueError, match="CUDA"):
        solve_box_qp_fused(torch.empty(B, n, n, **meta), torch.empty(B, n, **meta),
                           torch.empty(B, m, n, **meta), torch.empty(B, m, **meta),
                           torch.empty(B, m, **meta))
    assert build_qp.launches == 0 and solve_box_qp_fused.launches == 0


def test_k1_constants_match_the_kernel_struct():
    """The wrapper packs K1's scalars in the order of the kernel's
    ``K1Consts``; the kernel also checks the count at run time."""
    src = (PORT_DIR / "csrc" / "condense_qp.cu").read_text()
    body = re.search(r"struct K1Consts \{(.*?)\};", src, re.S).group(1)
    count = 0
    for decl in re.findall(r"float ([^;]+);", body):
        for name in decl.split(","):
            size = re.search(r"\[(\d+)\]", name)
            count += int(size.group(1)) if size else 1
    cfg = MPCConfig(T=20)
    consts = condense_qp._consts(cfg, bicycle_geometry().wheelbase)
    assert len(consts) == count
    assert consts[6:10] == tuple(w * cfg.T for w in cfg.qf)
    assert np.isclose(consts[-1], cfg.max_dsteer * cfg.dt)


@pytest.mark.parametrize("name", ["bicycle_geometry", "prius_geometry"])
def test_vehicle_geometry_copy_matches_the_jax_package(name):
    from mpc_for_av_at_intersection_tpu import models as jax_models
    from mpc_for_av_at_intersection_tpu_torch import models

    assert dataclasses.asdict(getattr(models, name)()) == dataclasses.asdict(
        getattr(jax_models, name)())
    assert [f.name for f in dataclasses.fields(models.VehicleGeometry)] == [
        f.name for f in dataclasses.fields(jax_models.VehicleGeometry)]
