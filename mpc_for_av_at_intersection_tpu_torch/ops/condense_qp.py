"""K1: the QP build of the controller tick (rollout + linearize + condense).

``build_qp`` launches the CUDA kernel ``csrc/condense_qp.cu`` for CUDA
tensors and runs ``build_qp_reference``, its plain PyTorch version, for CPU
tensors. Both return the condensed QP (P, q, G, lo, hi, F, g) in (B, ...)
layout, for the canonical controller (n = 2T, nx = 4) and for the jerk
variant (``cfg.jerk``: n = 2T+1, nx = 5). Replaces
``mpc_for_av_at_intersection_tpu/ops/condense_pallas.py``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.dynamics import SimLimits, plant_rollout
from ..mpc.condense import CondensedQP, condense
from ..mpc.jerk import condense_jerk
from ..mpc.linearize import linearize_bicycle
from . import _build
from ._build import SMEM_LIMIT


def build_qp_reference(states, oa, od, xref, reaches_end, cfg, wheelbase: float) -> CondensedQP:
    """Plain version: nonlinear rollout of the previous controls, bicycle
    linearization at deltabar = 0 (nx = 5 for the jerk variant), dense
    condensing."""
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    xbar = plant_rollout(states, torch.stack([oa, od], dim=-1), cfg.dt, wheelbase, limits)
    A, B, C = linearize_bicycle(xbar[:, :-1, 2], xbar[:, :-1, 3], torch.zeros_like(oa),
                                cfg.dt, wheelbase, nx=cfg.nx)
    return (condense_jerk if cfg.jerk else condense)(A, B, C, states, xref, reaches_end, cfg)


K1_TILE = 4             # csrc/condense_qp.cu: columns of a register tile of P (2 rows)


class K1Launch(NamedTuple):
    """The kernel's launch geometry at one horizon: n columns, the
    shared-memory row stride of F (n rounded up to a multiple of K1_TILE;
    the kernel's tiles of P span it) and the dynamic shared memory in bytes
    (``k1_smem_floats`` of the source)."""

    n: int
    stride: int
    smem_bytes: int


def k1_launch(T: int, jerk: bool) -> K1Launch:
    n = 2 * T + int(jerk)
    stride = -(-n // K1_TILE) * K1_TILE
    return K1Launch(n, stride, 4 * (4 * T * stride + 20 * T + 3 * ((T + 3) & ~3) + n * n))


def _consts(cfg, wheelbase: float):
    """Scalars in the order of the kernel's ``K1Consts``."""
    T = cfg.T
    return (cfg.dt, wheelbase, cfg.w_perp, cfg.w_para, cfg.q_v, cfg.q_yaw,
            *(w * T for w in cfg.qf), cfg.end_input_weight, cfg.r_accel, cfg.r_steer,
            cfg.rd_accel, cfg.rd_steer, cfg.min_speed, cfg.max_speed, cfg.max_decel,
            cfg.max_accel, cfg.max_steer, cfg.max_dsteer * cfg.dt, cfg.jerk_weight)


def build_qp(states, oa, od, xref, reaches_end, cfg, wheelbase: float) -> CondensedQP:
    """The condensed QP of a batch: states (B, 4), oa/od (B, T) previous
    controls, xref (B, 4, T+1), reaches_end (B, T+1) bool."""
    if states.device.type == "cpu":
        return build_qp_reference(states, oa, od, xref, reaches_end, cfg, wheelbase)
    B, T = oa.shape
    if T != cfg.T:
        raise ValueError(f"controls have horizon {T}, config has {cfg.T}")
    n, m = cfg.qp_dims
    nx = cfg.nx
    geo = k1_launch(T, cfg.jerk)
    if geo.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"build_qp: horizon {T} needs {geo.smem_bytes} B of shared memory "
                         f"> {SMEM_LIMIT}")
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
                      F=empty(nx * T, n), g=empty(nx * T))
    with torch.cuda.device(states.device):
        err = lib.k1_build_qp(
            states.data_ptr(), oa.data_ptr(), od.data_ptr(), xref.data_ptr(),
            reaches_end.data_ptr(), B, T, int(cfg.jerk), (ctypes.c_float * len(consts))(*consts),
            *(t.data_ptr() for t in out), geo.stride, geo.smem_bytes,
            _build.stream_handle(states.device))
    _build.raise_on_error("K1 build_qp", err)
    build_qp.launches += 1
    return out


build_qp.launches = 0
