"""Process-group set-up and experiment fan-out (port of
``dropoutdecoding_tpu/parallel/distributed.py``).

- ``init_multihost()``: ``torch.distributed.init_process_group`` for a run
  over several processes (NCCL between cards, gloo on the CPU); after it,
  ``parallel/mesh.make_mesh`` lays the ("data", "model") mesh over every
  rank.  Where the JAX package reads ``JAX_COORDINATOR_ADDRESS``, this reads
  torch's own ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``.
- ``shard_work()``: the deterministic round-robin split of an item list
  over the processes, for embarrassingly parallel evaluation (each process
  captions its share of the images; the JSONL outputs concatenate).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group.  A no-op returning False when no coordinator
    is given and the environment names none (``MASTER_ADDR``).

    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` /
    ``file://`` URL: a file rendezvous, for processes on one machine);
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``.  ``backend``: NCCL when CUDA is available, else gloo, unless
    given."""
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world)
    return True


def shard_work(items, process_index: int | None = None, process_count: int | None = None):
    """This process's share of a work list (stable round-robin)."""
    on = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]
