"""PyTorch port: import guard, configuration parity and kernel dispatch.

- A subprocess in which ``import jax`` fails imports every module of the
  port and runs CPU controller ticks (B=4, T=13: canonical, the jerk
  variant and the unpolished controller), one CPU fleet tick,
  ``plan_courses_device`` on ``free_area`` with both engines, the native
  host search, three ticks of the flagship driver's single-scenario
  episode, two multi-ego ticks (per ego and batched), two live-loop ticks
  through a checkpoint and the CLI's ``plan``: the port never imports JAX,
  at any depth, so it runs on a machine without it.
- Every entry point that makes tensors defaults to the card; the CLI with
  no card in view and no ``--device cpu`` exits non-zero.
- The controller profiler runs there too, its ADMM stages on the probes'
  plain versions.
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
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import QPSolution
from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
    polish_select,
    ruiz_admm_all_rounds,
    solve_box_qp_fused,
)
from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import (
    admm_all_rounds,
    admm_iterations,
    admm_round_full,
)
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
                       init_controller_state(cfg, device="cpu", batch=B), cfg, bicycle_geometry().wheelbase)
assert out.accel.shape == (B,) and bool(out.solved.all()), out.solved
assert bool(torch.isfinite(out.plan_xy).all())
assert build_qp.launches == 0 and solve_box_qp_fused.launches == 0
from mpc_for_av_at_intersection_tpu_torch.mpc.jerk import condense_jerk
from mpc_for_av_at_intersection_tpu_torch.ops.admm import polish_select, ruiz_admm_all_rounds
for cfg in (MPCConfig.with_jerk(), MPCConfig(T=13, polish=False)):
    cs = init_controller_state(cfg, device="cpu", batch=B)
    for _ in range(2):
        out = mpc_step_batched(torch.tensor(states, dtype=torch.float32),
                               torch.tensor(course, dtype=torch.float32), torch.zeros(B, N),
                               torch.full((B,), N, dtype=torch.int32), torch.full((B,), dl), cs, cfg,
                               bicycle_geometry().wheelbase)
        cs = out.state
    assert bool(out.solved.all()) and cs.qp_x.shape == (B, cfg.qp_dims[0]), (cfg, out.solved)
    assert bool(torch.isfinite(out.plan_xy).all())
assert (build_qp.launches, solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches,
        polish_select.launches) == (0, 0, 0, 0)
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig, engine_tick_fleet
from mpc_for_av_at_intersection_tpu_torch.lattice import plan_courses_device
from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch
from mpc_for_av_at_intersection_tpu_torch.worlds import free_area
res = plan_courses_device([free_area(goal_distance=15.0)], bicycle_geometry(), max_expansions=64,
                          device="cpu")
assert bool(res.found[0]) and int(res.n_points[0]) > 0
geom, world, st, _ = api.sample_intersection_fleet_batched(
    3, np.random.default_rng(0), n_steps=8, planner="host", starts=(1,), turns=(2,), device="cpu")
st, tel = engine_tick_fleet(world, st, EngineConfig(), geom)
assert bool(tel.solved.all()) and bool(torch.isfinite(st.ego).all())
assert astar_search_batch.launches == 0 and build_qp.launches == 0
from mpc_for_av_at_intersection_tpu_torch.ops.collision import frontier_collision
res = plan_courses_device([free_area(goal_distance=15.0)], bicycle_geometry(), engine="beam",
                          device="cpu")
assert bool(res.found[0]) and frontier_collision.launches == 0
courses, _ = api.plan_courses_batch([free_area(goal_distance=15.0)], bicycle_geometry(),
                                    planner="native", device="cpu")
assert len(courses[0]) > 0
from mpc_for_av_at_intersection_tpu_torch.bench_profile import profile_controller
from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import (
    admm_all_rounds, admm_iterations, admm_round_full)
report = profile_controller(batch=4, T=3, k_steps=1, reps=1, device="cpu")
assert report["admm_1round_ms"] > 0 and report["admm_all_ms"] > 0 and report["round_full_ms"] > 0
assert (admm_iterations.launches, admm_round_full.launches, admm_all_rounds.launches) == (0, 0, 0)
from mpc_for_av_at_intersection_tpu_torch.engine import (
    multi_ego_tick, multi_ego_tick_batched, run_episode)
setup = api.build_intersection(device="cpu", n_steps=3)
final, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, 3)
assert tel.x.shape == (3,) and bool(tel.solved.all()) and int(final.tick) == 3
setup = api.build_multi_ego_intersection(device="cpu", n_steps=2)
st, tel = multi_ego_tick(setup.world, setup.state0, setup.cfg, setup.geom)
st, tel = multi_ego_tick_batched(setup.world, st, setup.cfg, setup.geom)
assert tel.x.shape == (2,) and bool(tel.solved.all())
assert build_qp.launches == 0 and solve_box_qp_fused.launches == 0
import io, contextlib, json
from mpc_for_av_at_intersection_tpu_torch import cli
from mpc_for_av_at_intersection_tpu_torch.engine import run_episode_live
from mpc_for_av_at_intersection_tpu_torch.utils.checkpoint import load_state, save_state
setup = api.build_intersection(device="cpu", n_steps=2)
final, tel = run_episode_live(setup.world, setup.state0, setup.cfg, setup.geom, 2)
assert tel.x.shape == (2,) and bool(tel.solved.all())
import tempfile, os
with tempfile.TemporaryDirectory() as d:
    save_state(os.path.join(d, "s.npz"), final)
    assert int(load_state(os.path.join(d, "s.npz"), setup.state0).tick) == 2
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    cli.main(["plan", "--device", "cpu", "--backend", "python"])
assert json.loads(buf.getvalue())["expansions"] > 0
print("modules", len(names))
"""


def test_port_imports_and_ticks_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_TICK], cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 30


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
                "mpc.condense", "mpc.config", "mpc.controller", "mpc.jerk", "mpc.linearize", "mpc.qp",
                "mpc.reference", "ops.admm", "ops.condense_qp", "ops._build", "ops.astar",
                "worlds.obstacles", "worlds.scenario", "worlds.envs", "lattice.primitives",
                "lattice.astar", "lattice.search", "lattice.wavefront",
                "agents.moving_obstacles", "agents.prediction", "agents.collision",
                "engine.closed_loop", "engine.fleet", "parallel.mesh", "api", "ops.collision",
                "native", "native.build", "native.search", "ops.admm_probes", "ops.scan", "utils",
                "utils.benchtime", "utils.timing", "bench_profile", "bench_profile_engine",
                "core.transforms", "engine.multi_ego", "sweep", "cli", "__main__", "bench",
                "utils.checkpoint", "utils.plotting", "utils.grid_astar_demo",
                "parallel.distributed", "parallel.fleet_worker"):
        assert f"{port.__name__}.{sub}" in names


def test_entry_points_default_to_the_card():
    """Factories make tensors on the card unless the caller names the CPU
    (here, with no card, the default raises instead of picking the CPU)."""
    import inspect

    from mpc_for_av_at_intersection_tpu_torch import api, bench, engine, lattice, mpc, parallel
    from mpc_for_av_at_intersection_tpu_torch.parallel import distributed, fleet_worker
    from mpc_for_av_at_intersection_tpu_torch.utils import plotting

    factories = [mpc.init_controller_state, mpc.controller_state_from_numpy,
                 lattice.plan_courses_device, api.plan_courses_batch,
                 api.sample_intersection_fleet_batched, api.sample_intersection_fleet,
                 api.sample_intersection_fleet_geom, engine.make_world,
                 engine.init_engine_state, engine.world_from_numpy,
                 engine.engine_state_from_numpy, engine.make_multi_ego_world,
                 engine.init_multi_ego_state, api.build_intersection,
                 api.build_t_intersection_basic, api.build_roundabout,
                 api.build_intersection_multi_lane, api.build_intersection_speed_ref,
                 api.build_overtaking_cyclist, api.build_multi_ego_intersection,
                 bench.run_bench, plotting.primitive_fanout_trajectories,
                 fleet_worker.build_demo_fleet, distributed.initialize_process,
                 distributed.global_host_chip_mesh, distributed.local_device,
                 parallel.batch_mesh, parallel.host_chip_mesh]
    for fn in factories:
        default = inspect.signature(fn).parameters["device"].default
        assert default == torch.device("cuda"), fn.__name__
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            mpc.init_controller_state(MPCConfig(), batch=2)


def test_cli_without_a_card_exits_non_zero():
    """``--device cuda`` is the default: with no card in view the CLI stops
    with a message, and runs nothing on the CPU."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", port.__name__, "run", "--steps", "2"], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


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
                           torch.full((B,), 5.0 / (N - 1)), init_controller_state(cfg, device="cpu", batch=B),
                           cfg, bicycle_geometry().wheelbase)
    assert bool(out.solved.all())
    assert (build_qp.launches, solve_box_qp_fused.launches) == before == (0, 0)
    n, m = cfg.qp_dims
    P = torch.eye(n).expand(B, n, n).contiguous()
    G = torch.ones(B, m, n)
    vecs = (torch.zeros(B, n), -torch.ones(B, m), torch.ones(B, m), torch.full((B,), 0.1),
            torch.zeros(B, n), torch.zeros(B, m), torch.zeros(B, m))
    admm_iterations(P, G, *vecs, 5, 1e-6, 1.6)
    admm_round_full(P, G, *vecs, 5, 1e-6, 1.6)
    admm_all_rounds(P, G, *vecs, 2, 5, 1e-6, 1.6)
    assert (admm_iterations.launches, admm_round_full.launches, admm_all_rounds.launches) == (0, 0, 0)


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
    qp = (torch.empty(B, n, n, **meta), torch.empty(B, n, **meta), torch.empty(B, m, n, **meta),
          torch.empty(B, m, **meta), torch.empty(B, m, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        solve_box_qp_fused(*qp)
    with pytest.raises(ValueError, match="CUDA"):
        ruiz_admm_all_rounds(*qp)
    with pytest.raises(ValueError, match="CUDA"):
        polish_select(*qp, QPSolution(qp[1], qp[3], torch.empty(B, dtype=torch.bool, **meta),
                                      qp[3][:, 0], qp[3][:, 0]))
    jerk = MPCConfig.with_jerk()
    with pytest.raises(ValueError, match="CUDA"):
        build_qp(torch.empty(B, 4, **meta), torch.empty(B, T, **meta), torch.empty(B, T, **meta),
                 torch.empty(B, 4, T + 1, **meta), torch.empty(B, T + 1, dtype=torch.bool, **meta),
                 jerk, bicycle_geometry().wheelbase)
    probe_args = (qp[3], qp[3], qp[3][:, 0], qp[1], qp[3], qp[3])   # lo, hi, rho, x, z, y
    for name, call in (("Minv", lambda: admm_iterations(qp[0], qp[2], qp[1], *probe_args, 5,
                                                        1e-6, 1.6)),
                       ("P", lambda: admm_round_full(qp[0], qp[2], qp[1], *probe_args, 5,
                                                     1e-6, 1.6)),
                       ("P", lambda: admm_all_rounds(qp[0], qp[2], qp[1], *probe_args, 2, 5,
                                                     1e-6, 1.6))):
        with pytest.raises(ValueError, match=f"{name}: expected a CUDA"):
            call()
    assert build_qp.launches == 0 and solve_box_qp_fused.launches == 0
    assert ruiz_admm_all_rounds.launches == 0 and polish_select.launches == 0
    assert (admm_iterations.launches, admm_round_full.launches, admm_all_rounds.launches) == (0, 0, 0)


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
    assert np.isclose(consts[-2], cfg.max_dsteer * cfg.dt)
    assert consts[-1] == cfg.jerk_weight


def test_k3_constants_match_the_kernel_structs():
    """The wrapper packs K3's scalars in the order of ``K3Consts`` and
    ``K3Ints``; the kernel also checks the counts at run time."""
    from mpc_for_av_at_intersection_tpu_torch.lattice import SearchWeights, WavefrontConfig
    from mpc_for_av_at_intersection_tpu_torch.lattice.primitives import primitive_table
    from mpc_for_av_at_intersection_tpu_torch.lattice.wavefront import prepare_primitives
    from mpc_for_av_at_intersection_tpu_torch.ops import astar

    src = (PORT_DIR / "csrc" / "astar.cu").read_text()

    def count(struct, ctype):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
        return sum(len(d.split(",")) for d in re.findall(rf"{ctype} ([^;]+);", body))

    geom = bicycle_geometry()
    prims = prepare_primitives(primitive_table(geom), geom)
    B, O = 2, 32
    x = astar._prepare(torch.zeros(B, O, 8, 3), torch.zeros(B, O, dtype=torch.bool),
                       torch.zeros(B, 3), torch.zeros(B, 3), torch.zeros(B, 4), torch.zeros(B),
                       prims, WavefrontConfig(), SearchWeights.single_lane(), 100)
    assert len(x.fconsts) == count("K3Consts", "float")
    assert len(x.iconsts) == count("K3Ints", "int")
    assert x.iconsts[-1] == astar.level1_block(x.N) == 256   # cells of a level-1 block
    assert re.search(r"constexpr int K3_L1_MAX = (\d+);", src).group(1) == str(astar.L1_MAX)
    assert x.iconsts[4] == 1   # single_lane computes the edge obstacle term


def test_k3_signature_matches_the_kernel_entry_point():
    """ctypes passes each K3 argument as ``ops/_build.py`` declares it: a
    pointer for every pointer and the stream, an int for every int."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    src = (PORT_DIR / "csrc" / "astar.cu").read_text()
    params = re.search(r"\nint k3_astar\((.*?)\)\s*\{", src, re.S).group(1)
    kinds = [_build._I if re.match(r"\s*int \w+$", p) else _build._P for p in params.split(",")]
    assert _build._SIGNATURES["k3_astar"] == (kinds, _build._I)
    assert _build._SIGNATURES["k3_blocks_per_sm"] == ([_build._I], _build._I)
    assert _build.SOURCE_FLAGS["astar.cu"] == ("--fmad=false",)


def test_k1_signature_and_geometry_match_the_kernel():
    """ctypes passes each K1 argument as ``ops/_build.py`` declares it, and
    the wrapper's launch geometry uses the kernel's tile and shared-memory
    layout (``k1_smem_floats``)."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    src = (PORT_DIR / "csrc" / "condense_qp.cu").read_text()
    params = re.search(r"\nint k1_build_qp\((.*?)\)\s*\{", src, re.S).group(1)
    kinds = [_build._I if re.match(r"\s*int \w+$", p) else _build._P for p in params.split(",")]
    assert _build._SIGNATURES["k1_build_qp"] == (kinds, _build._I)
    assert _build._SIGNATURES["k1_blocks_per_sm"] == ([_build._I, _build._I], _build._I)
    assert int(re.search(r"K1_TILE = (\d+);", src).group(1)) == condense_qp.K1_TILE
    floats = re.search(r"k1_smem_floats\(int T, int n, int S\) \{\s*return (.*?);", src,
                       re.S).group(1)
    for T, jerk in ((5, False), (20, True), (30, False)):
        geo = condense_qp.k1_launch(T, jerk)
        assert 4 * eval(floats, {"T": T, "n": geo.n, "S": geo.stride}) == geo.smem_bytes


def test_k4_signature_matches_the_kernel_entry_point():
    """ctypes passes each K4 argument as ``ops/_build.py`` declares it: a
    pointer for every pointer and the stream, an int for every int."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, collision

    src = (PORT_DIR / "csrc" / "collision.cu").read_text()
    params = re.search(r'extern "C" int k4_frontier_collision\((.*?)\)\s*\{', src, re.S).group(1)
    kinds = [_build._I if re.match(r"\s*int \w+$", p) else _build._P for p in params.split(",")]
    assert _build._SIGNATURES["k4_frontier_collision"] == (kinds, _build._I)
    assert _build._SIGNATURES["k4_blocks_per_sm"] == ([_build._I], _build._I)
    assert _build.SOURCE_FLAGS["collision.cu"] == ("--fmad=false",)
    assert int(re.search(r"K4_MAX_OBS = (\d+);", src).group(1)) == collision.MAX_OBS
    assert int(re.search(r"K4_MAX_POINTS = (\d+);", src).group(1)) == collision.MAX_POINTS
    assert int(re.search(r"K4_MAX_PRIMS = (\d+);", src).group(1)) == collision.MAX_PRIMS


@pytest.mark.parametrize("entry", ["admm_iterations", "admm_round_full", "admm_all_rounds"])
def test_probe_signatures_match_the_kernel_entry_points(entry):
    """ctypes passes each probe argument as ``ops/_build.py`` declares it:
    a float for every float, an int for every int, a pointer for every
    pointer and the stream."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    src = (PORT_DIR / "csrc" / "admm.cu").read_text()
    params = re.search(rf"\nint {entry}\((.*?)\)\s*\{{", src, re.S).group(1).split(",")
    kinds = [_build._I if re.match(r"\s*int \w+$", p) else
             _build._F if re.match(r"\s*float \w+$", p) else _build._P for p in params]
    assert _build._SIGNATURES[entry] == (kinds, _build._I)
    assert kinds.count(_build._F) == 2


def test_package_exports_the_api_entry_points():
    from mpc_for_av_at_intersection_tpu_torch import api, lattice, ops

    for name in port._API:
        assert getattr(port, name) is getattr(api, name)
    assert lattice.wavefront_search is lattice.wavefront.wavefront_search
    assert ops.frontier_collision is ops.collision.frontier_collision
    assert ops.admm_iterations is ops.admm_probes.admm_iterations
    with pytest.raises(AttributeError):
        port.no_such_entry_point


@pytest.mark.parametrize("name", ["bicycle_geometry", "prius_geometry"])
def test_vehicle_geometry_copy_matches_the_jax_package(name):
    from mpc_for_av_at_intersection_tpu import models as jax_models
    from mpc_for_av_at_intersection_tpu_torch import models

    assert dataclasses.asdict(getattr(models, name)()) == dataclasses.asdict(
        getattr(jax_models, name)())
    assert [f.name for f in dataclasses.fields(models.VehicleGeometry)] == [
        f.name for f in dataclasses.fields(jax_models.VehicleGeometry)]
