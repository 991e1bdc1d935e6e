"""Multi-host support on ``torch.distributed``.

Port of ``tpu_orc/dist/multihost.py``: ``init_multihost`` (:31),
``global_mesh`` (:52), ``host_file_shard`` (:63) and ``is_coordinator``
(:74). The reference scales with SLURM array jobs over barcode files
(SURVEY.md §2.4); here one program runs in several processes:

  * every process calls :func:`init_multihost` (the coordinator's
    ``host:port``, the process count and this process's id, from its
    arguments or from the variables ``torchrun`` sets), which starts a
    ``torch.distributed`` process group, then :func:`global_mesh` builds
    a ('data', 'pair') mesh of this process's cards;
  * input FASTQ files are statically partitioned per process with
    :func:`host_file_shard` (file-level sharding mirrors the reference's
    one-task-one-file model, so no reads move between hosts);
  * the demux steps' histograms are summed across the group
    (``dist/sharded.py::all_reduce_sum``): the only data that crosses
    processes, besides a barrier.

Where ``tpu_orc``'s global mesh spans every process's devices and its
collectives ride the mesh, a mesh here holds one process's devices and
the collectives go through the process group. The backend is the
caller's choice: "nccl" (the default, collectives on the cards) takes a
card for each process of the host, as NCCL refuses two ranks on one
card; "gloo" runs on the host and lets processes share a card or run
without one.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh

BACKENDS = ("nccl", "gloo")


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "nccl") -> Tuple[int, int]:
    """Start the process group from the arguments or the variables
    ``torchrun`` sets (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK;
    LOCAL_RANK and LOCAL_WORLD_SIZE for the card of a process, else its
    id and the process count, all on one host). Returns (process_id,
    num_processes). Without a coordinator and a process count, or when
    the group is up already, it starts nothing (one host).

    "nccl" raises where the host has fewer cards than processes; it
    makes card LOCAL_RANK this process's current card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if _group_up():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if not (coordinator_address and num_processes):
        return 0, 1
    pid = int(process_id or 0)
    if backend == "nccl":
        local_rank = int(env.get("LOCAL_RANK", pid))
        local_size = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_size > cards:
            raise RuntimeError(f"nccl: {local_size} processes on this host "
                               f"and {cards} CUDA devices; NCCL needs a "
                               f"card for each (use gloo to share one)")
        torch.cuda.set_device(local_rank)
        kw = {"device_id": torch.device("cuda", local_rank)}
    else:
        kw = {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=pid, **kw)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(pair_axis: int = 1, devices: Optional[Sequence] = None
                ) -> Mesh:
    """('data', 'pair') mesh over this process's devices: the given ones,
    else this process's current card when a process group of more than
    one process is up, else every visible card. Banks replicate per
    device; reads stripe over 'data'."""
    if devices is None:
        if _group_up() and dist.get_world_size() > 1:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = list(make_mesh().devices.flat)
    n = len(devices)
    if n % pair_axis:
        pair_axis = 1
    return make_mesh((n // pair_axis, pair_axis), devices=devices)


def host_file_shard(paths: Sequence[str],
                    process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[str]:
    """Deterministic per-process partition of input files (sorted,
    round-robin) — the multi-host analogue of the reference's
    SLURM-array task->file mapping (03_amplicon_sorter.sh:119-135)."""
    up = _group_up()
    pid = (dist.get_rank() if up else 0) if process_id is None \
        else process_id
    n = (dist.get_world_size() if up else 1) if num_processes is None \
        else num_processes
    return [p for i, p in enumerate(sorted(paths)) if i % n == pid]


def is_coordinator() -> bool:
    """Process 0 writes run-level outputs (consensusfile, reports); other
    processes write only their own bins."""
    return not _group_up() or dist.get_rank() == 0
