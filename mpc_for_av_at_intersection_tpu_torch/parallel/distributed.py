"""Multi-process entry path.

Port of ``mpc_for_av_at_intersection_tpu/parallel/distributed.py``. The JAX
design is one controller process per host owning that host's chips,
``jax.distributed.initialize`` wiring the processes into one runtime. The
torch design is one process per GPU: ``initialize_process`` joins this
process to a ``torch.distributed`` process group (NCCL between cards, gloo
between CPU processes), and the scenario batch shards over the ranks of the
global ``(hosts, chips)`` mesh (``parallel.mesh.run_batch_episodes``), the
fleet summary all-reduced over it.

Launch one process per card with ``torchrun --nproc-per-node=<cards>``
(``env://``: torchrun sets the rank, the world size and the rendezvous), or
give every process the coordinator's ``host:port``, the process count and
its rank — ``python -m mpc_for_av_at_intersection_tpu_torch.parallel.fleet_worker``
does either.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..mpc.controller import CUDA

__all__ = ["initialize_process", "global_host_chip_mesh", "local_device"]


def local_device(device=CUDA) -> torch.device:
    """This rank's device: on CUDA the card ``initialize_process`` selected,
    else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", torch.cuda.current_device())


def initialize_process(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    emulate_local_devices: Optional[int] = None,
    device=CUDA,
) -> None:
    """Join this process to the default process group.

    The backend follows ``device``: NCCL on CUDA (this process then works on
    the card of its host-local rank, ``local_device()``), gloo on the CPU;
    a backend that fails to start raises, and nothing falls back to another. With a coordinator
    (``host:port``), ``num_processes`` and ``process_id``, the group meets
    at ``tcp://<coordinator>``; without, at ``env://`` (torchrun's
    variables).

    ``emulate_local_devices`` (the JAX version's several virtual CPU
    devices per process) has no torch meaning: a rank owns one device, so
    the port refuses it. A CPU run of the multi-process program is
    ``device="cpu"`` (gloo), one device a process.
    """
    import torch.distributed as dist

    if emulate_local_devices is not None:
        raise ValueError("emulate_local_devices: a torch rank owns one device; run N CPU "
                         "processes with device='cpu' (gloo) instead")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        # torchrun names the host-local rank; an explicit rendezvous, the rank
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")


def global_host_chip_mesh(device=CUDA):
    """The global ``(hosts, chips)`` mesh over every rank in the group.

    Axis 1 is a host's ranks (``LOCAL_WORLD_SIZE`` of them under torchrun:
    one a card, NVLink between them), axis 0 the hosts; without torchrun
    each process stands for a host of one device, as the JAX version's
    emulated hosts. Valid only after ``initialize_process``.
    """
    import torch.distributed as dist

    from .mesh import host_chip_mesh

    world = dist.get_world_size()
    per = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if world % per:
        raise ValueError(f"{world} ranks not divisible into hosts of {per}")
    return host_chip_mesh(world // per, device)
