"""PyTorch port, the program's spans and counters on the CPU
(``utils/timing.py``: ``span``, ``count``, ``counters``).

- Under a CPU-only ``torch.profiler`` session each fleet tick
  (``engine_tick_fleet`` over 6 scenarios, ``multi_ego_fleet_tick`` over
  two junctions of two egos) opens every span of its stages once a tick,
  under the parent the stage table gives.
- With no profiler session a tick opens no ``record_function`` and counts
  nothing.
- Three traced sessions in one process each read their own totals: two
  ticks read apart sum to the same two ticks read together.
- A session that counts past ``COUNT_KEEP`` elements folds what it kept
  and reads the same totals, holding a bounded number of tensors.
- ``ruiz_admm_batched`` counts a factorization a check block while its
  rho band is <= 1, and with a band of 5 as many as its rows' rho moved,
  counted by hand from the rho each number of blocks leaves.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.agents import stack_agents
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    engine_tick_fleet,
    init_multi_ego_state,
    make_multi_ego_world,
    multi_ego_fleet_tick,
)
from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_stack
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import ruiz_admm_batched
from mpc_for_av_at_intersection_tpu_torch.utils import timing
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

torch.set_num_threads(2)

CFG = EngineConfig()
GEOM = bicycle_geometry()
TICKS = ("engine_tick_fleet", "multi_ego_fleet_tick")
PARENT = {"tick.predict": None, "tick.pre": None, "pre.scan": "tick.pre", "tick.mpc": None,
          "mpc.k1": "tick.mpc", "mpc.k2": "tick.mpc", "tick.post": None}


class Fleet:
    """A small fleet: its tick, its first state and its rows."""

    def __init__(self, tick, state0, rows):
        self.tick, self.state0, self.rows = tick, state0, rows


def _scenarios():
    _, world, st, _ = api.sample_intersection_fleet_batched(
        6, np.random.default_rng(11), cfg=CFG, n_steps=40, planner="host", starts=(1, 4),
        turns=(1, 2), device="cpu")
    return Fleet(lambda s: engine_tick_fleet(world, s, CFG, GEOM), st, 6)


def _junctions():
    params, agents = stack_agents([], n_slots=CFG.n_agents)
    courses = [api.plan_course(intersection(turn_indicator=turn, start_pos=start), GEOM,
                               use_native=True) for start, turn in ((1, 2), (4, 1))]
    one = make_multi_ego_world(courses, params, CFG, device="cpu")
    st = init_multi_ego_state(one, agents, CFG, 12, device="cpu")
    world, st = tree_stack([one, one]), tree_stack([st, st])
    return Fleet(lambda s: multi_ego_fleet_tick(world, s, CFG, GEOM), st, 4)


@pytest.fixture(scope="module")
def fleets():
    return {"engine_tick_fleet": _scenarios(), "multi_ego_fleet_tick": _junctions()}


def traced(fleet, st, ticks, path):
    """``ticks`` ticks from ``st`` under a CPU-only profiler; (state, the
    program's spans in the trace as (start, end, name))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(ticks):
            st, _ = fleet.tick(st)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return st, [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e.get("cat") == "user_annotation"]


def parent_of(span, spans):
    """The innermost other span that holds ``span``."""
    holders = [s for s in spans if s is not span and s[0] <= span[0] and span[1] <= s[1]]
    return max(holders, key=lambda s: s[0])[2] if holders else None


@pytest.mark.parametrize("name", TICKS)
def test_every_span_opens_once_a_tick_under_its_parent(name, fleets, tmp_path):
    fleet = fleets[name]
    _, spans = traced(fleet, fleet.state0, 2, tmp_path / "trace.json")
    assert sorted(s[2] for s in spans) == sorted(list(PARENT) * 2)
    for s in spans:
        assert parent_of(s, spans) == PARENT[s[2]], s
    got = timing.counters()
    assert set(got) == {"k2.checks", "k2.factorizations"}
    assert 2 * fleet.rows <= got["k2.factorizations"] <= got["k2.checks"]


@pytest.mark.parametrize("name", TICKS)
def test_without_a_profiler_a_tick_opens_no_span_and_counts_nothing(name, fleets, monkeypatch):
    fleet = fleets[name]
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda n: opened.append(n))
    monkeypatch.setattr(timing, "_COUNTS", {})
    fleet.tick(fleet.state0)
    assert opened == [] and timing.counters() == {}


def test_each_traced_session_reads_its_own_totals(fleets, tmp_path):
    fleet = fleets["engine_tick_fleet"]
    st1, _ = traced(fleet, fleet.state0, 1, tmp_path / "a.json")
    first = timing.counters()
    traced(fleet, st1, 1, tmp_path / "b.json")
    second = timing.counters()
    traced(fleet, fleet.state0, 2, tmp_path / "c.json")
    both = timing.counters()
    assert set(first) == set(second) == set(both) == {"k2.checks", "k2.factorizations"}
    for k in both:
        assert first[k] > 0 and second[k] > 0
        assert both[k] == first[k] + second[k]


def test_counts_past_the_kept_elements_fold_to_the_same_totals(monkeypatch):
    monkeypatch.setattr(timing, "COUNT_KEEP", 10)
    g = torch.Generator().manual_seed(3)
    parts = [torch.randint(0, 9, (4,), generator=g, dtype=torch.int32) for _ in range(40)]
    with profile(activities=[ProfilerActivity.CPU]):
        for t in parts:
            timing.count("a", t)
            timing.count("b", 2 * t.float())
            # 4 elements a count: at most two tensors and a folded total
            assert len(timing._COUNTS["a"]) <= 3 and len(timing._COUNTS["b"]) <= 3
    want = sum(int(t.sum()) for t in parts)
    assert timing.counters() == {"a": want, "b": 2 * want}


def _box_qps(B=24, n=8, m=14, seed=5):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    P = A @ A.transpose(1, 2) + 0.1 * torch.eye(n, dtype=torch.float64)
    q = torch.randn(B, n, generator=g, dtype=torch.float64)
    G = torch.randn(B, m, n, generator=g, dtype=torch.float64)
    lo = -torch.rand(B, m, generator=g, dtype=torch.float64) - 0.1
    return P, q, G, lo, -lo


def test_plain_solver_counts_a_factorization_a_block_within_a_band_of_one():
    kw = dict(rounds=8, iters=6, eps=1e-4, stall_cap=1e-3, ruiz_iters=3)
    for band in (0.0, 1.0):
        sol = ruiz_admm_batched(*_box_qps(), refactor_band=band, **kw)
        assert torch.equal(sol.factorizations, sol.checks)


def test_plain_solver_counts_the_factorizations_its_rho_band_asks_for():
    """With a band of 5 a row is factorized in its first block and again
    in each block whose rho differs from the block before; the rho a
    solve of k blocks returns is the one its last block used (a converged
    row's stays)."""
    qp, rounds = _box_qps(), 12
    kw = dict(iters=4, refactor_band=5.0, eps=1e-3, ruiz_iters=3)
    rhos = torch.stack([ruiz_admm_batched(*qp, rounds=k, **kw).rho for k in range(1, rounds + 1)])
    by_hand = 1 + (rhos[1:] != rhos[:-1]).sum(0).to(rhos.dtype)
    sol = ruiz_admm_batched(*qp, rounds=rounds, **kw)
    assert torch.equal(sol.factorizations, by_hand)
    # rows refactorized none, one and two times, all in fewer blocks than
    # they ran, some of them converged before the last block
    assert set(by_hand.tolist()) >= {1.0, 2.0, 3.0}
    assert bool((sol.factorizations < sol.checks).all())
    assert 0 < int((sol.checks < rounds).sum()) < len(by_hand)
