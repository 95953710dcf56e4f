"""PyTorch port: batch runs over a device mesh, the multi-process worker.

- ``run_batch_episodes(mesh=None)`` on ``tests/test_parallel.py``'s
  8-scenario demo fleet (``parallel.fleet_worker.build_demo_fleet``) against
  JAX's ``fast=False`` (vmap of the single-scenario episode) and
  ``fast=True`` (the fleet engine): summary equal, the ego within 2e-4 and
  the steer within 5e-4 (the bars of ``tests/test_torch_fleet.py``). The
  port's ``fast`` changes nothing (one route).
- Two ``fleet_worker`` processes on gloo over localhost: their JSON lines
  agree and equal the single-process summary, over the ``(hosts, chips)``
  mesh (2, 1), and (1, 2) when ``LOCAL_WORLD_SIZE`` says both ranks share
  a host.
- In one process, a one-rank gloo group: ``batch_mesh``/``host_chip_mesh``
  shapes and names, the mesh run equal to the run without, and the
  refusals (a batch that does not divide, ranks that do not divide into
  hosts, ``emulate_local_devices``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mpc_for_av_at_intersection_tpu.parallel import run_batch_episodes as jax_run_batch
from mpc_for_av_at_intersection_tpu.parallel.fleet_worker import (
    build_demo_fleet as jax_build_demo_fleet,
)
from mpc_for_av_at_intersection_tpu_torch.parallel import (
    batch_mesh,
    host_chip_mesh,
    run_batch_episodes,
)
from mpc_for_av_at_intersection_tpu_torch.parallel.distributed import (
    global_host_chip_mesh,
    initialize_process,
)
from mpc_for_av_at_intersection_tpu_torch.parallel.fleet_worker import build_demo_fleet
from mpc_for_av_at_intersection_tpu_torch.parallel.mesh import _own_rows

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
B, STEPS = 8, 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _summary(s):
    return {k: int(v) for k, v in s.items()}


@pytest.fixture(scope="module")
def port_run():
    cfg, geom, wb, sb = build_demo_fleet(B, STEPS, device="cpu")
    return (cfg, geom, wb, sb), run_batch_episodes(wb, sb, cfg, geom, STEPS)


@pytest.mark.parametrize("fast", [False, True])
def test_batch_episodes_match_jax(port_run, fast):
    _, (final, tel, summary) = port_run
    cfg, geom, wb, sb = jax_build_demo_fleet(B, STEPS)
    jfinal, jtel, jsummary = jax_run_batch(wb, sb, cfg, geom, STEPS, mesh=None, fast=fast)
    assert _summary(summary) == _summary(jsummary)
    assert tel.x.shape == (B, STEPS) == np.asarray(jtel.x).shape
    np.testing.assert_allclose(final.ego.numpy(), np.asarray(jfinal.ego), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tel.steer.numpy(), np.asarray(jtel.steer), atol=5e-4, rtol=0)
    np.testing.assert_array_equal(tel.solved.numpy(), np.asarray(jtel.solved))


def test_fast_is_one_route(port_run):
    (cfg, geom, wb, sb), (final, tel, summary) = port_run
    f2, t2, s2 = run_batch_episodes(wb, sb, cfg, geom, STEPS, fast=True)
    assert _summary(s2) == _summary(summary)
    assert torch.equal(f2.ego, final.ego) and torch.equal(t2.steer, tel.steer)


@pytest.mark.parametrize("local_world,mesh", [(None, {"hosts": 2, "chips": 1}),
                                              ("2", {"hosts": 1, "chips": 2})])
def test_two_process_gloo_fleet_worker(port_run, local_world, mesh):
    summary = _summary(port_run[1][2])
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_WORLD_SIZE", "LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "2"
    if local_world:
        env["LOCAL_WORLD_SIZE"] = local_world
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpc_for_av_at_intersection_tpu_torch.parallel.fleet_worker",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid),
         "--device", "cpu", "--batch", str(B), "--steps", str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for pid in (0, 1)]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        reports.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["process_id"] for r in reports] == [0, 1]
    for r in reports:
        assert r["process_count"] == 2 and r["global_devices"] == 2 and r["device"] == "cpu"
        assert r["mesh"] == mesh
        assert {k: r[k] for k in summary} == summary


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_over_one_rank(one_rank_group, port_run, monkeypatch):
    (cfg, geom, wb, sb), (final, tel, summary) = port_run
    m1 = batch_mesh("cpu")
    assert m1.mesh_dim_names == ("batch",) and tuple(m1.shape) == (1,)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    m2 = global_host_chip_mesh("cpu")
    assert m2.mesh_dim_names == ("hosts", "chips") and tuple(m2.shape) == (1, 1)
    assert tuple(host_chip_mesh(1, "cpu").shape) == (1, 1)
    with pytest.raises(ValueError, match="hosts"):
        host_chip_mesh(2, "cpu")
    for mesh in (m1, m2):
        f, t, s = run_batch_episodes(wb, sb, cfg, geom, STEPS, mesh=mesh)
        assert _summary(s) == _summary(summary)
        assert torch.equal(f.ego, final.ego) and torch.equal(t.steer, tel.steer)


class _Mesh:
    """A stand-in mesh of 4 ranks, this one at coordinate (1, 0) of (2, 2)."""
    shape = (2, 2)

    def size(self):
        return 4

    def get_coordinate(self):
        return [1, 0]


def test_rows_split_over_the_flattened_mesh():
    assert _own_rows(_Mesh(), 8) == slice(4, 6)
    with pytest.raises(ValueError, match="divide"):
        _own_rows(_Mesh(), 6)


def test_emulated_devices_are_refused():
    with pytest.raises(ValueError, match="one device"):
        initialize_process("127.0.0.1:1", 1, 0, emulate_local_devices=4, device="cpu")
    assert not dist.is_initialized()
