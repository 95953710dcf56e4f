"""Checkpoint / resume for long-running fleet simulations.

Port of ``mpc_for_av_at_intersection_tpu/utils/checkpoint.py``. Any engine
state (single-, multi-ego or batched: a NamedTuple of tensors, nested) round
trips through a flat ``.npz`` snapshot, and ``run_chunked`` runs an episode
in chunks with a checkpoint after each so a preempted sweep resumes where it
stopped.

The file format is the JAX package's: ``leaf_{i}`` for the i-th leaf in
NamedTuple field order, depth first (JAX's tree flatten of the same
NamedTuples), and ``__treedef__`` the structure as JAX prints it. So a
snapshot written by the JAX package loads here and the episode continues
(``EngineState``, ``ControllerState``, ``AgentStates`` and ``Telemetry``
have the same fields in the same order in both packages). JAX drops
``None`` leaves from a flatten, so a state holding ``None`` is refused
rather than saved with its leaves shifted.
"""

from __future__ import annotations

import os
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_state", "load_state", "run_chunked"]


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tensor or of nested (named) tuples, depth first."""
    if tree is None:
        raise ValueError("checkpoint: a None leaf has no place in a snapshot "
                         "(JAX's flatten drops it, so the leaf order would differ)")
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _treedef(tree) -> str:
    """The structure as JAX's ``str(treedef)`` spells it for NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], "
                f"[{', '.join(_treedef(v) for v in tree)}])")
    if isinstance(tree, tuple):
        return f"({', '.join(_treedef(v) for v in tree)})"
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` in order."""
    if isinstance(like, tuple):
        items = [_unflatten(v, leaves) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    return next(leaves)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_state(path, state) -> None:
    """Snapshot a (nested) NamedTuple of tensors to ``path`` (atomic rename)."""
    leaves = _leaves(state)
    path = pathlib.Path(path)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(
        tmp,
        __treedef__=np.frombuffer(f"PyTreeDef({_treedef(state)})".encode(), dtype=np.uint8),
        **{f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)},
    )
    os.replace(tmp, path)


def load_state(path, like):
    """Restore a snapshot; ``like`` gives the structure, and each leaf takes
    its dtype and device. The snapshot's leaf count (and its shapes) must
    equal ``like``'s."""
    like_leaves = _leaves(like)
    with np.load(path) as data:
        if "__treedef__" in data.files:
            n_saved = data["__treedef__"].tobytes().decode().count("*")
            if n_saved != len(like_leaves):
                raise ValueError(f"checkpoint {path}: {n_saved} leaves, the state has "
                                 f"{len(like_leaves)}")
        restored = []
        for i, leaf in enumerate(like_leaves):
            arr = np.asarray(data[f"leaf_{i}"])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {path}: leaf {i} has shape {arr.shape}, the "
                                 f"state {tuple(leaf.shape)}")
            restored.append(torch.as_tensor(arr).to(dtype=leaf.dtype, device=leaf.device))
    return _unflatten(like, iter(restored))


def run_chunked(
    step_many,          # (state, n_steps) -> (state, telemetry)
    state0,
    n_steps: int,
    chunk: int,
    ckpt_path: Optional[str] = None,
) -> Tuple[object, list]:
    """Run ``n_steps`` in chunks, checkpointing after each chunk.

    If ``ckpt_path`` exists, resumes from it (the saved state carries its
    own tick counter). Returns (final_state, list of per-chunk telemetry as
    numpy).
    """
    state = state0
    done_steps = 0
    if ckpt_path and pathlib.Path(ckpt_path).exists():
        state = load_state(ckpt_path, state0)
        tick = getattr(state, "tick", None)
        done_steps = int(tick.max()) if tick is not None else 0

    tels = []
    while done_steps < n_steps:
        this = min(chunk, n_steps - done_steps)
        state, tel = step_many(state, this)
        tels.append(_unflatten(tel, map(_numpy, _leaves(tel))))
        done_steps += this
        if ckpt_path:
            save_state(ckpt_path, state)
    return state, tels
