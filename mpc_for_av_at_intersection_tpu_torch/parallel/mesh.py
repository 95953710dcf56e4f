"""Scale-out over the scenario batch axis: batch runs on one device or
sharded over the ranks of a device mesh.

Port of ``mpc_for_av_at_intersection_tpu/parallel/mesh.py``. Within one
scenario all coupling (vehicle pairs, the condensed QP) fits on a card, so
the only distributed axis is the scenario batch: each rank of a
``torch.distributed`` device mesh runs its contiguous rows of the batch on
its own device, and the only communication is the ``all_reduce`` of the
fleet summary (hierarchically, over the mesh's ``chips`` axis and then its
``hosts`` axis, as the JAX ``psum`` over both). A JAX process addresses
only its own shards of the global arrays; a rank here returns only its own
rows.

The JAX version's ``_cached_batch_runner`` (a memoized jit of the whole
batch episode) has no counterpart: nothing is traced, so there is nothing
to cache.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.closed_loop import EngineConfig, EngineState, WorldArrays, tree_map, tree_stack
from ..engine.fleet import run_fleet_episodes
from ..models import VehicleGeometry
from ..mpc.controller import CUDA


def batch_mesh(device=CUDA):
    """1-D mesh over every rank of the default process group, axis
    ``batch`` (``parallel.distributed.initialize_process`` first)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (dist.get_world_size(),),
                            mesh_dim_names=("batch",))


def host_chip_mesh(n_hosts: int, device=CUDA):
    """2-axis ``(hosts, chips)`` mesh over every rank of the default process
    group — the SURVEY §5.8 topology: the all-reduce runs over ``chips``
    (NVLink within a host) and then over ``hosts``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % n_hosts:
        raise ValueError(f"{n} ranks not divisible into {n_hosts} hosts")
    return init_device_mesh(torch.device(device).type, (n_hosts, n // n_hosts),
                            mesh_dim_names=("hosts", "chips"))


def stack_worlds(worlds) -> WorldArrays:
    """Stack single-scenario worlds along a new leading axis."""
    return tree_stack(list(worlds))


def stack_states(states) -> EngineState:
    """Stack single-scenario engine states along a new leading axis."""
    return tree_stack(list(states))


def _summarize(final, tel):
    return {
        "n_done": final.done.to(torch.int32).sum(),
        "ticks_to_goal_sum": final.ticks_to_goal.sum(),
        "n_unsolved_ticks": (~tel.solved).to(torch.int32).sum(),
    }


def _own_rows(mesh, batch: int):
    """This rank's contiguous rows of the batch over the flattened mesh."""
    n = mesh.size()
    if batch % n:
        raise ValueError(f"batch of {batch} scenarios does not divide over {n} ranks")
    index = int(np.ravel_multi_index(tuple(mesh.get_coordinate()), tuple(mesh.shape)))
    per = batch // n
    return slice(index * per, (index + 1) * per)


def run_batch_episodes(
    world_batch: WorldArrays,
    state_batch: EngineState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
    n_steps: int,
    mesh=None,
    fast: bool = False,
):
    """Run a batch of scenarios in lockstep for ``n_steps`` ticks.

    Without a mesh: the whole batch on its device. With a mesh (a
    ``DeviceMesh`` of ``batch_mesh``, ``host_chip_mesh`` or
    ``distributed.global_host_chip_mesh``): this rank runs its contiguous
    rows of the batch (the batch must divide over the mesh's ranks, else
    ``ValueError``) on the device its tensors are on, and the summary is
    all-reduced over the mesh.

    Both run the fleet engine (``run_fleet_episodes``: K1 and K2 once a
    tick on the card). ``fast`` is kept for call parity with the JAX
    package, where it picks the fleet engine over a vmap of the
    single-scenario episode; the port's ``run_episode`` is the fleet engine
    at B=1, so the two are one computation here and ``fast`` changes
    nothing.

    Returns (final_states, telemetry with fields (B, T, ...), summary):
    the rows this rank ran and the summary of the whole batch (scenarios
    finished, ticks-to-goal sum, unsolved ticks, 0-d tensors).
    """
    del fast
    if mesh is not None:
        rows = _own_rows(mesh, world_batch.course.shape[0])
        world_batch = tree_map(lambda t: t[rows], world_batch)
        state_batch = tree_map(lambda t: t[rows], state_batch)
    final, tel = run_fleet_episodes(world_batch, state_batch, cfg, geom, n_steps)
    tel = type(tel)(*(t.transpose(0, 1) for t in tel))
    summary = _summarize(final, tel)
    if mesh is not None:
        import torch.distributed as dist

        counts = torch.stack([summary[k].to(torch.int64) for k in summary])
        for dim in reversed(range(mesh.ndim)):     # chips, then hosts
            dist.all_reduce(counts, group=mesh.get_group(dim))
        summary = dict(zip(summary, counts.unbind()))
    return final, tel, summary
