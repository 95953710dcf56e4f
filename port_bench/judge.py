"""The comparison that decides ``correct``.

The window keeps, for ticks drawn from the seed, the program's state
before the tick, its state after it and the tick's telemetry (references
to the tensors the timed path made; nothing is copied inside the window).
Once the window has closed, rows drawn from the seed are gathered from
them by the traffic kind's ``gather`` (``kinds/<kind>.py``), and the
reference the configuration names (``reference.py`` for the canonical
controller) works the tick out again in float64 from the state before
it. The reference follows the program tick by tick from the
program's own state: a closed loop cannot be replayed apart from it.

Numbers (each a reading over every sampled row of every sampled tick):

- ``pre_mismatch``: the share of rows whose pre-stage decisions (done,
  localization index, cut course length, conflict found) differ;
- ``control_gap_max``, ``_p99``, ``_p90``, ``_p50``: over live rows whose decisions
  agree, that the program solved and whose optimum the reference
  certified, the gap of the commanded (accel, steer) to the optimum's, each
  over its actuator range (``inf`` where no row is left to compare);
- ``plant_gap``: the widest gap of the ego and the scripted agents after
  the post stage to the plant step of the program's own command;
- ``unsolved_share``: the share of the rows the program left live at the
  tick whose solve it reported unsolved (the controller brakes there).

The check file of the cell (``workloads/<cell>.json``) names the numbers
compared and their limits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import spec

DECISIONS = ("done", "agent_idx", "cutoff_len", "collision_found")


def draw(check: dict, episode_ticks: int, rows: int, seed: int):
    """The sampled ticks (tick 0, the cold one, and ``ticks`` - 1 others)
    and, for each, the sampled rows."""
    rng = np.random.default_rng([seed, 20261018])
    others = rng.choice(np.arange(1, episode_ticks), size=check["ticks"] - 1, replace=False)
    ticks = [0] + sorted(int(t) for t in others)
    return {t: np.sort(rng.choice(rows, size=min(check["rows"], rows), replace=False))
            for t in ticks}


def run_reference(kind, ref, inputs, C, dtype=torch.float64):
    """The reference's tick of the gathered rows in ``dtype``; with it the
    scripted agents' step (frozen with a finished row where the kind
    freezes its scenario's agents)."""
    preds, active = ref.obstacles(inputs["junction"], inputs["rows"], C, dtype)
    res = ref.tick(inputs["world"], inputs["state"], preds, active, C, dtype)
    agents = {k: (v.to(dtype) if v.is_floating_point() else v)
              for k, v in inputs["junction"]["agents"].items()}
    new = ref.agent_step(agents, C["mpc"]["dt"], C["vehicle"]["wheelbase"])
    if kind.FREEZE_AGENTS_WITH_DONE:
        new = torch.where(res["done"][:, None, None], agents["pose"], new)
    res["agents_pose"] = new
    res["solved"] = torch.ones_like(res["done"])
    return res


def readings(kind, reference, inputs, out, ref, C) -> dict:
    """The numbers of one sampled tick (sums and lists, merged by
    ``combine``)."""
    mpc = C["mpc"]
    f64 = torch.float64
    mism = torch.zeros_like(ref["done"])
    by_field = {}
    for k in DECISIONS:
        differ = out[k].to(ref[k].dtype) != ref[k]
        by_field[k] = int(differ.sum())
        mism |= differ
    live = ~mism & ~out["done"] & out["solved"] & ref["certified"]
    da = (out["accel"].to(f64) - ref["accel"].to(f64)).abs() / (mpc["max_accel"] - mpc["max_decel"])
    ds = (out["steer"].to(f64) - ref["steer"].to(f64)).abs() / (2 * mpc["max_steer"])
    gaps = torch.maximum(da, ds)[live]

    # the post stage on the program's own command, in float64
    st = inputs["state"]
    ego0 = st["ego"].to(f64)
    plant = reference.plant_step(ego0, out["accel"].to(f64), out["steer"].to(f64), C)
    ego_ref = torch.where(out["done"][:, None], ego0, plant)
    agents = {k: (v.to(f64) if v.is_floating_point() else v)
              for k, v in inputs["junction"]["agents"].items()}
    ag_ref = reference.agent_step(agents, mpc["dt"], C["vehicle"]["wheelbase"])
    if kind.FREEZE_AGENTS_WITH_DONE:
        ag_ref = torch.where(out["done"][:, None, None], agents["pose"], ag_ref)
    plant_gap = max(float((out["ego"].to(f64) - ego_ref).abs().amax()),
                    float((out["agents_pose"].to(f64) - ag_ref).abs().amax()))
    return {"rows": int(mism.numel()), "mismatched": int(mism.sum()), "by_field": by_field,
            "gaps": gaps.cpu(), "plant_gap": plant_gap,
            "live": int((~ref["done"]).sum()),
            "program_live": int((~out["done"]).sum()),
            "unsolved": int((~out["solved"] & ~out["done"]).sum()),
            "uncertified": int((~ref["certified"] & ~ref["done"]).sum())}


def combine(parts) -> dict:
    rows = sum(p["rows"] for p in parts)
    gaps = torch.cat([p["gaps"] for p in parts]) if parts else torch.zeros(0)
    inf = float("inf")
    if len(gaps):
        q = torch.quantile(gaps, torch.tensor([0.5, 0.9, 0.99], dtype=gaps.dtype))
        gap_max, p50, p90, p99 = float(gaps.max()), float(q[0]), float(q[1]), float(q[2])
    else:
        gap_max = p50 = p90 = p99 = inf
    return {
        "pre_mismatch": sum(p["mismatched"] for p in parts) / max(rows, 1),
        "control_gap_max": gap_max,
        "control_gap_p99": p99,
        "control_gap_p90": p90,
        "control_gap_p50": p50,
        "plant_gap": max((p["plant_gap"] for p in parts), default=inf),
        "unsolved_share": (sum(p["unsolved"] for p in parts)
                           / max(sum(p["program_live"] for p in parts), 1)),
        "rows": rows,
        "mismatched_by_field": {k: sum(p["by_field"][k] for p in parts) for k in DECISIONS},
        "rows_compared": int(len(gaps)),
        "live_rows": sum(p["live"] for p in parts),
        "uncertified": sum(p["uncertified"] for p in parts),
    }


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the compared numbers."""
    shown = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown


def judge(kind_name, world, captures, draws, config, device, control=False):
    """The numbers over the captured ticks. ``control`` puts the reference
    computed in bfloat16 in the program's place. A kind with a ``judge``
    of its own is judged by it."""
    kind = spec.kind(kind_name)
    if hasattr(kind, "judge"):
        return kind.judge(world, captures, draws, config, device, control)
    reference = spec.reference(config)
    C = reference.constants(config)
    parts = []
    for t, rows in draws.items():
        if t not in captures:
            continue
        before, after, tel = captures[t]
        inputs, out = kind.gather(world, before, after, tel, rows, device)
        ref = run_reference(kind, reference, inputs, C)
        if control:
            low = run_reference(kind, reference, inputs, C, torch.bfloat16)
            out = {k: low[k] for k in out}
        parts.append(readings(kind, reference, inputs, out, ref, C))
    return combine(parts)
