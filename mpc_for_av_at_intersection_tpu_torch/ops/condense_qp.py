"""K1: the QP build of the controller tick (rollout + linearize + condense).

``build_qp`` launches the CUDA kernel ``csrc/condense_qp.cu`` for CUDA
tensors and runs ``build_qp_reference``, its plain PyTorch version, for CPU
tensors. Both return the condensed QP (P, q, G, lo, hi, F, g) in (B, ...)
layout. Replaces ``mpc_for_av_at_intersection_tpu/ops/condense_pallas.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.dynamics import SimLimits, plant_rollout
from ..mpc.condense import CondensedQP, condense
from ..mpc.linearize import linearize_bicycle
from . import _build


def build_qp_reference(states, oa, od, xref, reaches_end, cfg, wheelbase: float) -> CondensedQP:
    """Plain version: nonlinear rollout of the previous controls, bicycle
    linearization at deltabar = 0, dense condensing."""
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    xbar = plant_rollout(states, torch.stack([oa, od], dim=-1), cfg.dt, wheelbase, limits)
    A, B, C = linearize_bicycle(xbar[:, :-1, 2], xbar[:, :-1, 3], torch.zeros_like(oa),
                                cfg.dt, wheelbase)
    return condense(A, B, C, states, xref, reaches_end, cfg)


def _consts(cfg, wheelbase: float):
    """Scalars in the order of the kernel's ``K1Consts``."""
    T = cfg.T
    return (cfg.dt, wheelbase, cfg.w_perp, cfg.w_para, cfg.q_v, cfg.q_yaw,
            *(w * T for w in cfg.qf), cfg.end_input_weight, cfg.r_accel, cfg.r_steer,
            cfg.rd_accel, cfg.rd_steer, cfg.min_speed, cfg.max_speed, cfg.max_decel,
            cfg.max_accel, cfg.max_steer, cfg.max_dsteer * cfg.dt)


def build_qp(states, oa, od, xref, reaches_end, cfg, wheelbase: float) -> CondensedQP:
    """The condensed QP of a batch: states (B, 4), oa/od (B, T) previous
    controls, xref (B, 4, T+1), reaches_end (B, T+1) bool."""
    if states.device.type == "cpu":
        return build_qp_reference(states, oa, od, xref, reaches_end, cfg, wheelbase)
    if cfg.jerk:
        raise NotImplementedError("K1 covers the canonical 4-state controller")
    B, T = oa.shape
    if T != cfg.T:
        raise ValueError(f"controls have horizon {T}, config has {cfg.T}")
    n, m = 2 * T, 4 * T - 1
    for name, t, shape in (("states", states, (B, 4)), ("oa", oa, (B, T)),
                           ("od", od, (B, T)), ("xref", xref, (B, 4, T + 1))):
        _build.check_cuda(name, t, shape)
    _build.check_cuda("reaches_end", reaches_end, (B, T + 1), torch.bool)

    lib = _build.load()
    consts = _consts(cfg, wheelbase)
    if len(consts) != lib.k1_num_consts():
        raise RuntimeError("K1 constants do not match the kernel's K1Consts")

    def empty(*shape):
        return torch.empty((B,) + shape, dtype=torch.float32, device=states.device)

    out = CondensedQP(P=empty(n, n), q=empty(n), G=empty(m, n), lo=empty(m), hi=empty(m),
                      F=empty(4 * T, n), g=empty(4 * T))
    with torch.cuda.device(states.device):
        err = lib.k1_build_qp(
            states.data_ptr(), oa.data_ptr(), od.data_ptr(), xref.data_ptr(),
            reaches_end.data_ptr(), B, T, (ctypes.c_float * len(consts))(*consts),
            *(t.data_ptr() for t in out), _build.stream_handle(states.device))
    _build.raise_on_error("K1 build_qp", err)
    build_qp.launches += 1
    return out


build_qp.launches = 0
