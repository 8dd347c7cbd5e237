"""Multi-process job parallelism (port of
``smcdet_tpu/parallel/distributed.py``, on ``torch.distributed``).

The reference shards long experiment runs over processes by hand, with a
``BATCH_INDEX`` environment variable per process. Here the batch runner
derives its shard from the process group: each process of a group of
``world_size`` takes the batches ``b`` with ``b % world_size == rank``.
The processes never communicate inside a sampler, so the group only
bootstraps ranks: it uses the gloo backend (no collective runs on a card,
and two NCCL ranks cannot share one GPU, while two job processes on one
card overlap their host work).

The group is found from the arguments or from the standard environment
(``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); nothing on a
machine announces a cluster, so a run with neither has nothing to join.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

__all__ = ["initialize_distributed", "is_distributed", "host_shard"]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           require: bool = False,
                           timeout_s: float = 600.0) -> bool:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` of rank 0's store (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (default ``WORLD_SIZE``), ``process_id`` this process's rank (default
    ``RANK``). With neither arguments nor environment:

    - ``require=False`` (the library default): a single-process no-op that
      returns False, so single-process runs need no special case;
    - ``require=True`` (the ``--distributed`` CLI contract): raises
      ``RuntimeError``, never running every process on the whole job
      against the same output paths.

    A group given in part (an address without a world size or rank, or
    the reverse) raises ``ValueError``. Returns True when the group has
    more than one process.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])

    if coordinator_address is None and num_processes is None:
        if not require:
            return False
        raise RuntimeError(
            "--distributed: no process group to join; set MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK (or pass them)")
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a process group needs its coordinator address, its number of "
            f"processes and this process's rank; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def is_distributed() -> bool:
    """Whether this process belongs to a group of more than one."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def host_shard(job_index: int = 0, num_jobs: int = 1) -> tuple[int, int]:
    """The ``(job_index, num_jobs)`` shard of this process. An explicit
    shard (``num_jobs != 1``, the reference's ``BATCH_INDEX``) wins;
    otherwise, in a group of more than one process, the rank and the world
    size."""
    if num_jobs != 1:
        return job_index, num_jobs
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return job_index, num_jobs
