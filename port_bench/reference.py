"""Plain reference of one closed-loop control tick, written from the
upstream controller's semantics (``main/scenarios/mpc_intersection.py``,
``main/lib/mpc.py``, ``main/lib/collision_avoidance.py``,
``main/lib/moving_obstacles*.py``, ``main/lib/simulation.py``).

It imports nothing of the program: it takes the tick's inputs (one world
row and the state before the tick, as plain tensors) and the constants of
the configuration file, and works out in ``dtype`` (float64 for the
reference, bfloat16 for the control) what the tick should produce:

1. the scripted agents' commands and every obstacle's constant-control
   prediction;
2. the pre stage: goal test, localization advance, reachability resample
   of the course, the frame-windowed conflict scan and the course cutoff;
3. the controller: velocity-lookahead reference, the operating-point
   rollout and its linearization, the condensed QP, and its exact optimum
   by a primal-dual interior-point method (a different algorithm from the
   program's ADMM and polish);
4. the post stage: the plant step and the scripted agents' step.

Torch has no factorization in bfloat16, so the control solves its
bfloat16-built QP in float32 and rounds the result to bfloat16.
"""

from __future__ import annotations

import math

import torch

BIG = 1e30


def _c(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------- constants

def constants(config: dict) -> dict:
    """The constants the reference reads from a configuration file. It
    knows the canonical controller only (no speed reference, no jerk
    state, one linearization, no yielding by speed) and refuses another:
    a configuration of another controller names a reference of its own.
    The vehicle has two collision circles of radius w/sqrt(2) on the
    heading axis (upstream ``car_dimensions.py:67-90``)."""
    mpc = config["mpc"]
    if mpc["speed_ref"] or mpc["jerk"] or mpc["max_iter"] != 1 \
            or config["engine"]["yield_by_speed"]:
        raise NotImplementedError("the reference knows the canonical controller only")
    v = dict(config["vehicle"])
    spread = v["length"] / 2.0 - v["width"] / 2.0
    cx = v["wheelbase"] / 2.0
    v["circle_centers"] = [[cx + spread, 0.0], [cx - spread, 0.0]]
    v["radius"] = v["width"] / math.sqrt(2.0)
    return {"mpc": mpc, "engine": config["engine"], "vehicle": v}


# ---------------------------------------------------------------- agents

def agent_commands(agent, dt):
    """(x, y, v, yaw, a, steer) of every scripted agent (..., A, 6). The
    cells' agents follow the T-intersection schedule (policy 0) or drive
    straight (policy 2); another policy is refused."""
    pose, counter = agent["pose"], agent["counter"]
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    policy = agent["policy"]
    if bool(((policy != 0) & (policy != 2) & agent["active"]).any()):
        raise NotImplementedError("the reference knows the T-intersection and arterial agents")
    zero = torch.zeros_like(x)
    pos = torch.where((x >= agent["x_turn"]) & (th > -math.pi / 2), zero - 0.38, zero)
    neg = torch.where((x <= agent["x_turn"]) & (th < 3 * math.pi / 2), zero + 0.19, zero)
    steer = torch.where(agent["direction"] >= 0, pos, neg)
    steer = torch.where(agent["turning"] & (policy == 0), steer, zero)
    delayed = (agent["offset"] > 0) & (counter.to(x.dtype) * dt <= agent["offset"])
    v = torch.where(delayed, zero, agent["speed"])
    return torch.stack([x, y, v, th, zero, steer], dim=-1)


def agent_step(agent, dt, wheelbase):
    """The scripted agents' poses after one tick (inactive slots kept)."""
    cmd = agent_commands(agent, dt)
    x, y, v, th, steer = cmd[..., 0], cmd[..., 1], cmd[..., 2], cmd[..., 3], cmd[..., 5]
    new = torch.stack([x + v * torch.cos(th) * dt, y + v * torch.sin(th) * dt,
                       th + v / wheelbase * torch.tan(steer) * dt], dim=-1)
    return torch.where(agent["active"][..., None], new, agent["pose"])


def predict(obs6, dt, wheelbase, n_steps):
    """Constant-control Euler prediction (..., n_steps, 3), the initial pose
    left out; the heading step uses the already updated speed (upstream
    ``moving_obstacles_prediction.py:26-27``)."""
    x, y, v, yaw, a, steer = obs6.unbind(-1)
    out = []
    for _ in range(n_steps):
        x = x + v * torch.cos(yaw) * dt
        y = y + v * torch.sin(yaw) * dt
        v = v + a * dt
        yaw = yaw + v / wheelbase * torch.tan(steer) * dt
        out.append(torch.stack([x, y, yaw], dim=-1))
    return torch.stack(out, dim=-2)


# ----------------------------------------------------------------- curves

def nearest_in_direction(xy, path, start, valid):
    """Upstream ``trajectories.py:100-126``: the three nearest points at or
    after ``start`` and before ``valid``; i0 where i1 and i2 straddle it,
    max(i0, i1) where i1 is next to i0, else i0. Two points left: start+1;
    fewer: start."""
    N = path.shape[1]
    k = torch.arange(N, device=path.device)
    d2 = ((path - xy[:, None, :]) ** 2).sum(-1)
    inside = (k[None] >= start[:, None]) & (k[None] < valid[:, None])
    d2 = torch.where(inside, d2, _c(BIG, d2))
    order = torch.sort(d2, dim=1, stable=True).indices[:, :3]
    i0, i1, i2 = order[:, 0], order[:, 1], order[:, 2]
    pick = torch.where((i1 - i2).abs() == 2, i0,
                       torch.where((i0 - i1).abs() == 1, torch.maximum(i0, i1), i0))
    left = (valid - start).clamp(min=0)
    return torch.where(left >= 3, pick, torch.where(left == 2, start + 1, start))


def rows_at(path, idx):
    return torch.gather(path, 1, idx[:, None, None].expand(-1, 1, path.shape[2]))[:, 0]


def circles(x, y, th, centers):
    """Collision-circle centers (..., n_c, F) of poses (..., F)."""
    c, s = torch.cos(th)[..., None, :], torch.sin(th)[..., None, :]
    ox, oy = centers[:, 0:1], centers[:, 1:2]
    return x[..., None, :] + c * ox - s * oy, y[..., None, :] + s * ox + c * oy


def first_true(mask):
    """(found, index of the first True) along the last axis."""
    found = mask.any(-1)
    k = torch.arange(mask.shape[-1], device=mask.device)
    idx = torch.where(mask, k, mask.shape[-1]).amin(-1)
    return found, torch.where(found, idx, 0)


# ------------------------------------------------------------- pre stage

def pre_stage(w, st, preds, active, C, dtype):
    """The tick up to the QP for rows (R, ...). Returns a dict of the
    decisions and the cut course length."""
    mpc, eng, veh = C["mpc"], C["engine"], C["vehicle"]
    dt = mpc["dt"]
    course, n_course, dl = w["course"], w["n_course"], w["dl"]
    ego, R, N = st["ego"], course.shape[0], course.shape[1]
    dev = course.device
    k = torch.arange(N, device=dev)

    # goal test on the previous tick's controller state (mpc.py:310-326)
    near = torch.hypot(ego[:, 0] - w["goal_xy"][:, 0], ego[:, 1] - w["goal_xy"][:, 1]) \
        <= mpc["goal_dist"]
    at_end = (st["target_idx"] - st["cutoff_len"]).abs() < 5
    done_now = st["done"] | (near & at_end & (ego[:, 2].abs() <= mpc["stop_speed"]))

    # localization advance, frozen once the cut course has collapsed
    tip = rows_at(course, (st["cutoff_len"] - 1).clamp(min=0))
    collapsed = (rows_at(course, st["agent_idx"]) == tip).all(-1)
    agent_idx = torch.where(st["first_tick"] | ~collapsed,
                            nearest_in_direction(ego[:, :2], course[..., :2], st["agent_idx"],
                                                 n_course),
                            st["agent_idx"])

    # reachability resample of the course from agent_idx on
    rows = (agent_idx[:, None] + k[None]).clamp(max=N - 1)
    detail = torch.gather(course, 1, rows[..., None].expand(R, N, 3))
    n_detail = n_course - agent_idx
    v = ego[:, 2:3]
    step = dt * torch.where(v < mpc["max_speed"],
                            (v + mpc["max_accel"] * (k[None] + 1.0)).clamp(max=mpc["max_speed"]),
                            _c(mpc["max_speed"], v).expand(R, N))
    valid = k[None] < n_detail[:, None]
    seg = torch.zeros((R, N), dtype=dtype, device=dev)
    seg[:, 1:] = (detail[:, 1:, :2] - detail[:, :-1, :2]).norm(dim=-1)
    seg = torch.where(valid, seg, torch.zeros_like(seg))
    q = torch.floor(torch.cumsum(seg, 1) / step)
    keep = torch.ones((R, N), dtype=torch.bool, device=dev)
    keep[:, 1:] = (q[:, 1:] - q[:, :-1]) >= 1.0
    keep[torch.arange(R, device=dev), (valid.sum(1) - 1).clamp(min=0)] = True
    keep &= valid
    n_ego = keep.sum(1)
    n_frames = eng["n_frames"]
    frames = torch.arange(n_frames, device=dev)
    # the kept points in order, the last one repeated to the buffer's end
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    pick = torch.minimum(frames[None], (n_ego - 1).clamp(min=0)[:, None])
    ego_traj = torch.gather(detail, 1, torch.gather(order, 1, pick)[..., None].expand(-1, -1, 3))

    # frame-windowed conflict scan: the first hit in (frame, ego circle,
    # obstacle, shift, obstacle circle) order
    centers = torch.as_tensor(veh["circle_centers"], dtype=dtype, device=dev)
    radius = veh["radius"]
    reach = (2.0 * radius) ** 2
    W = eng["frame_window"]
    n_pred = preds.shape[2]
    shifts = torch.arange(-W, W + 1, device=dev)
    src = (frames[None] - shifts[:, None]).clamp(0, n_pred - 1)          # (S, F)
    ex, ey = circles(ego_traj[..., 0], ego_traj[..., 1], ego_traj[..., 2], centers)
    ox, oy = circles(preds[..., 0], preds[..., 1], preds[..., 2], centers)  # (R, O, c, P)
    frame_ok = frames[None] < torch.maximum(n_ego, _c(n_pred, n_ego))[:, None]
    hits = []
    for r0 in range(0, R, 32):
        sl = slice(r0, r0 + 32)
        sx = ox[sl][..., src]                                           # (r, O, c, S, F)
        sy = oy[sl][..., src]
        dx = ex[sl][:, :, None, None, None, :] - sx[:, None]           # (r, ce, O, co, S, F)
        dy = ey[sl][:, :, None, None, None, :] - sy[:, None]
        hit = (dx * dx + dy * dy <= reach) & active[sl][:, None, :, None, None, None]
        hit = hit & frame_ok[sl][:, None, None, None, None, :]
        hits.append(hit.permute(0, 5, 1, 2, 4, 3).reshape(hit.shape[0], -1))
    found, first = first_true(torch.cat(hits))
    n_c, O, S = centers.shape[0], preds.shape[1], 2 * W + 1
    co = first % n_c
    s_i = (first // n_c) % S
    o_i = (first // (n_c * S)) % O
    f_i = first // (n_c * S * O * n_c)
    pose = preds[torch.arange(R, device=dev), o_i, (f_i - shifts[s_i]).clamp(0, n_pred - 1)]
    px = pose[:, 0] + torch.cos(pose[:, 2]) * centers[co, 0] - torch.sin(pose[:, 2]) * centers[co, 1]
    py = pose[:, 1] + torch.sin(pose[:, 2]) * centers[co, 0] + torch.cos(pose[:, 2]) * centers[co, 1]
    # the conflict point relocalized on the detailed path, circle-major
    dxp, dyp = circles(detail[..., 0], detail[..., 1], detail[..., 2], centers)
    hit2 = ((dxp - px[:, None, None]) ** 2 + (dyp - py[:, None, None]) ** 2 <= reach) \
        & valid[:, None, :]
    frame_idx = first_true(hit2.reshape(R, -1))[1] % N
    xy = rows_at(detail, frame_idx)[:, :2]

    # cutoff a car length before the conflict (mpc_intersection.py:129-136)
    near_pt = ((course[..., :2] - xy[:, None]) ** 2).sum(-1).sqrt() <= 0.001
    cut_found, cut_idx = first_true(near_pt & (k[None] < n_course[:, None]))
    margin = 4 * torch.ceil(radius / dl).to(torch.int64)
    cut = torch.maximum(agent_idx + 1, cut_idx - margin)
    cutoff_len = torch.where(found & cut_found, cut, n_course)
    return dict(done=done_now, agent_idx=agent_idx, cutoff_len=cutoff_len,
                collision_found=found & ~done_now)


# ------------------------------------------------------------ controller

def plant_step(state, a, delta, C):
    """Upstream ``simulation.py:35-47``: steer clamped, position and heading
    on the speed before the update, the speed clamped after it."""
    mpc, L = C["mpc"], C["vehicle"]["wheelbase"]
    dt = mpc["dt"]
    delta = delta.clamp(-mpc["max_steer"], mpc["max_steer"])
    x, y, v, yaw = state.unbind(-1)
    return torch.stack([x + v * torch.cos(yaw) * dt, y + v * torch.sin(yaw) * dt,
                        (v + a * dt).clamp(mpc["min_speed"], mpc["max_speed"]),
                        yaw + v / L * torch.tan(delta) * dt], dim=-1)


def tracking_reference(w, st, valid, T, dt):
    """Velocity-lookahead reference (mpc.py:86-109): (xref (R, 4, T+1),
    reaches_end (R, T+1))."""
    course = w["course"]
    ego = st["ego"]
    target = nearest_in_direction(ego[:, :2], course[..., :2], st["target_idx"], valid)
    ov = torch.where(st["have_ov"][:, None], st["ov"],
                     ego[:, 2:3].clamp(min=10.0 / 3.6).expand(-1, T + 1))
    travel = torch.cumsum(ov.abs() * dt, 1)
    idx = torch.minimum(torch.round(travel / w["dl"][:, None]).to(torch.int64) + target[:, None],
                        valid[:, None] - 1)
    pts = torch.gather(course, 1, idx[..., None].expand(-1, -1, 3))
    xref = torch.stack([pts[..., 0], pts[..., 1], torch.zeros_like(pts[..., 0]), pts[..., 2]], 1)
    return xref, idx == valid[:, None] - 1


def condensed_qp(w, st, valid, C, dtype):
    """The tick's QP in the inputs u = (a_0, d_0, ..., a_{T-1}, d_{T-1}):
    min 1/2 u'Pu + q'u s.t. lo <= Gu <= hi, the states eliminated through
    the dynamics linearized about the rollout of the previous plan at zero
    steer (mpc.py:58-79, 112-194)."""
    mpc, L = C["mpc"], C["vehicle"]["wheelbase"]
    T, dt = mpc["T"], mpc["dt"]
    ego = st["ego"]
    R, dev = ego.shape[0], ego.device
    oa = torch.where(st["have_prev"][:, None], st["oa"], torch.zeros_like(st["oa"]))
    od = torch.where(st["have_prev"][:, None], st["od"], torch.zeros_like(st["od"]))
    xref, ends = tracking_reference(w, st, valid, T, dt)

    x = ego
    F = torch.zeros((R, 4, 2 * T), dtype=dtype, device=dev)
    g = ego
    Fs, gs = [], []
    for t in range(T):
        v, phi = x[:, 2], x[:, 3]
        A = torch.eye(4, dtype=dtype, device=dev).repeat(R, 1, 1)
        A[:, 0, 2], A[:, 0, 3] = dt * torch.cos(phi), -dt * v * torch.sin(phi)
        A[:, 1, 2], A[:, 1, 3] = dt * torch.sin(phi), dt * v * torch.cos(phi)
        c = torch.stack([dt * v * torch.sin(phi) * phi, -dt * v * torch.cos(phi) * phi,
                         torch.zeros_like(v), torch.zeros_like(v)], 1)
        F = A @ F
        F[:, 2, 2 * t] = dt
        F[:, 3, 2 * t + 1] = dt * v / L
        g = (A @ g[..., None])[..., 0] + c
        Fs.append(F)
        gs.append(g)
        x = plant_step(x, oa[:, t], od[:, t], C)
    F = torch.stack(Fs, 1)                                   # (R, T, 4, n)
    g = torch.stack(gs, 1)                                   # (R, T, 4)

    yaw = xref[:, 3, 1:]
    c, s = torch.cos(yaw), torch.sin(yaw)
    Q = torch.zeros((R, T, 4, 4), dtype=dtype, device=dev)
    Q[..., 0, 0] = mpc["w_perp"] * s * s + mpc["w_para"] * c * c
    Q[..., 0, 1] = Q[..., 1, 0] = (mpc["w_para"] - mpc["w_perp"]) * c * s
    Q[..., 1, 1] = mpc["w_perp"] * c * c + mpc["w_para"] * s * s
    Q[..., 2, 2], Q[..., 3, 3] = mpc["q_v"], mpc["q_yaw"]
    Qf = torch.diag(torch.as_tensor(mpc["qf"], dtype=dtype, device=dev) * T)
    Q = torch.where(ends[:, 1:, None, None], Qf, Q)
    err = g - xref[:, :, 1:].transpose(1, 2)
    QF = Q @ F
    P = torch.einsum("rtin,rtim->rnm", F, QF)
    q = torch.einsum("rtin,rti->rn", QF, err)
    rw = torch.tensor([mpc["r_accel"], mpc["r_steer"]], dtype=dtype, device=dev)
    rdiag = torch.where(ends[:, :T, None], _c(mpc["end_input_weight"], P), rw).reshape(R, 2 * T)
    P = P + torch.diag_embed(rdiag)
    D = torch.zeros((2 * (T - 1), 2 * T), dtype=dtype, device=dev)
    i = torch.arange(2 * (T - 1), device=dev)
    D[i, i], D[i, i + 2] = -1.0, 1.0
    rd = torch.tensor([mpc["rd_accel"], mpc["rd_steer"]], dtype=dtype, device=dev).repeat(T - 1)
    P = 2.0 * (P + (D.T * rd) @ D)
    P = 0.5 * (P + P.transpose(1, 2))
    q = 2.0 * q

    eye = torch.eye(2 * T, dtype=dtype, device=dev)
    G = torch.cat([F[:, :, 2], eye[0::2].expand(R, -1, -1), eye[1::2].expand(R, -1, -1),
                   D[1::2].expand(R, -1, -1)], 1)
    rate = mpc["max_dsteer"] * dt
    ones_t = torch.ones((R, T), dtype=dtype, device=dev)
    ones_r = torch.ones((R, T - 1), dtype=dtype, device=dev)
    lo = torch.cat([mpc["min_speed"] - g[..., 2], mpc["max_decel"] * ones_t,
                    -mpc["max_steer"] * ones_t, -rate * ones_r], 1)
    hi = torch.cat([mpc["max_speed"] - g[..., 2], mpc["max_accel"] * ones_t,
                    mpc["max_steer"] * ones_t, rate * ones_r], 1)
    return P, q, G, lo, hi


def interior_point(P, q, G, lo, hi, iters=60, tol=1e-9):
    """Mehrotra predictor-corrector on min 1/2 u'Pu + q'u, lo <= Gu <= hi,
    batched. Returns (u, certified): certified rows meet the KKT conditions
    to ``tol`` relative to the data's size."""
    Cm = torch.cat([G, -G], 1)
    d = torch.cat([hi, -lo], 1)
    R, n = q.shape
    m = d.shape[1]
    x = torch.zeros_like(q)
    s = (d - (Cm @ x[..., None])[..., 0]).clamp(min=1.0)
    lam = torch.ones_like(d)
    CT = Cm.transpose(1, 2)
    tiny = torch.finfo(q.dtype).tiny
    alive = torch.ones(R, dtype=torch.bool, device=q.device)

    def mv(A, v):
        return (A @ v[..., None])[..., 0]

    def factor(H):
        """Cholesky of H; a row whose H is not positive definite in this
        precision (the control's rounded P) gets a growing multiple of its
        largest diagonal entry added, at last the diagonal alone."""
        L, info = torch.linalg.cholesky_ex(H)
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        scale = H.diagonal(dim1=1, dim2=2).abs().amax(1)[:, None, None] + 1.0
        reg = 100 * torch.finfo(H.dtype).eps
        while bool((info != 0).any()) and reg < 1.0:
            bad = info != 0
            L2, info2 = torch.linalg.cholesky_ex(H[bad] + reg * scale[bad] * eye)
            L[bad], info[bad] = L2, info2
            reg *= 100
        bad = info != 0
        if bool(bad.any()):
            L[bad] = torch.diag_embed(H[bad].diagonal(dim1=1, dim2=2).abs().sqrt() + 1.0)
        return L

    def max_step(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, BIG))
        return ratio.amin(1).clamp(max=1.0)

    scale = 1.0 + q.abs().amax(1) + P.abs().amax((1, 2))
    dscale = 1.0 + d.abs().amax(1)

    def converged():
        stat = (mv(P, x) + q + mv(CT, lam)).abs().amax(1) / scale
        viol = (mv(Cm, x) - d).clamp(min=0).amax(1) / dscale
        gap = (s * lam).sum(1) / m
        return (stat <= tol) & (viol <= tol) & (gap <= tol * scale)

    for _ in range(iters):
        # a converged row stops: past convergence its Newton system
        # only grows worse conditioned
        alive &= ~converged()
        if not bool(alive.any()):
            break
        rd = mv(P, x) + q + mv(CT, lam)
        rp = mv(Cm, x) + s - d
        mu = (s * lam).sum(1) / m
        wv = lam / s
        H = P + CT @ (wv[..., None] * Cm)
        L = factor(H)

        def direction(rc):
            rhs = -rd - mv(CT, (-rc + lam * rp) / s)
            dx = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            ds = -rp - mv(Cm, dx)
            return dx, ds, (-rc - lam * ds) / s

        dx, ds, dl = direction(s * lam)
        a = torch.minimum(max_step(s, ds), max_step(lam, dl))
        mu_aff = ((s + a[:, None] * ds) * (lam + a[:, None] * dl)).sum(1) / m
        sigma = (mu_aff / mu).clamp(min=0.0) ** 3
        dx, ds, dl = direction(s * lam + ds * dl - (sigma * mu)[:, None])
        a = 0.99 * torch.minimum(max_step(s, ds), max_step(lam, dl))
        nx = x + a[:, None] * dx
        ns = (s + a[:, None] * ds).clamp(min=tiny)
        nl = (lam + a[:, None] * dl).clamp(min=tiny)
        # a row whose step leaves the finite numbers (a QP that the
        # control's rounding made non-convex) stops at its last iterate
        alive &= nx.isfinite().all(1) & ns.isfinite().all(1) & nl.isfinite().all(1)
        x = torch.where(alive[:, None], nx, x)
        s = torch.where(alive[:, None], ns, s)
        lam = torch.where(alive[:, None], nl, lam)

    return x, converged()


def controller(w, st, cutoff_len, C, dtype):
    """The commanded (accel, steer) at the QP's optimum and whether the
    optimum is certified."""
    mpc = C["mpc"]
    P, q, G, lo, hi = condensed_qp(w, st, cutoff_len, C, dtype)
    solve = torch.float64 if dtype == torch.float64 else torch.float32
    u, certified = interior_point(*(t.to(solve) for t in (P, q, G, lo, hi)))
    u = u.to(dtype)
    return (u[:, 0].clamp(mpc["max_decel"], mpc["max_accel"]),
            u[:, 1].clamp(-mpc["max_steer"], mpc["max_steer"]), certified)


# ------------------------------------------------------------------ tick

def obstacles(junction, rows, C, dtype):
    """Every obstacle's prediction (R, O, n_pred, 3) and each row's active
    mask (R, O). ``junction`` holds the scripted agents (J, A, ...) and,
    for a multi-ego junction, its egos (J, E, 4) with their last steer;
    ``rows`` (R, 2) name each row's junction and ego (-1 for a fleet
    row, whose only obstacles are the scripted agents)."""
    dt, L = C["mpc"]["dt"], C["vehicle"]["wheelbase"]
    n_pred = int(math.ceil(C["engine"]["time_horizon"] / dt))
    j, e = rows[:, 0], rows[:, 1]
    obs6 = agent_commands({k: v[j] for k, v in junction["agents"].items()}, dt)
    active = junction["agents"]["active"][j]
    if "egos" in junction:
        egos = junction["egos"][j]                                      # (R, E, 4)
        E = egos.shape[1]
        peers = torch.stack([egos[..., 0], egos[..., 1], egos[..., 2], egos[..., 3],
                             torch.zeros_like(egos[..., 0]), junction["last_steer"][j]], -1)
        obs6 = torch.cat([peers, obs6], 1)
        not_self = torch.arange(E, device=rows.device)[None] != e[:, None]
        active = torch.cat([not_self, active], 1)
    return predict(obs6.to(dtype), dt, L, n_pred), active


def tick(w, st, preds, active, C, dtype=torch.float64):
    """One tick of rows (R, ...) given their obstacles' predictions: the
    decisions of the pre stage, the commanded controls, the ego after the
    plant step and whether the QP's optimum was certified."""
    f = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in w.items()}
    s = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in st.items()}
    for d in (f, s):
        for k, v in d.items():
            if v.dtype in (torch.int32, torch.int16):
                d[k] = v.to(torch.int64)
    pre = pre_stage(f, s, preds.to(dtype), active, C, dtype)
    accel, steer, certified = controller(f, s, pre["cutoff_len"], C, dtype)
    done = pre["done"]
    # a finished row freezes: its localization index too (QUIRKS #21)
    pre["agent_idx"] = torch.where(done, s["agent_idx"], pre["agent_idx"])
    accel = torch.where(done, torch.zeros_like(accel), accel)
    steer = torch.where(done, torch.zeros_like(steer), steer)
    ego = torch.where(done[:, None], s["ego"], plant_step(s["ego"], accel, steer, C))
    return dict(pre, accel=accel, steer=steer, ego=ego, certified=certified)
