"""Multi-process bootstrap of the port: one process a card.

Port of ``repro/launch/distributed_init.py``.  Each process of a job
runs the same program; :func:`maybe_initialize_distributed` reads the
launcher's environment (the same variables as the JAX package, with the
SLURM fallbacks) and joins the processes into one
``torch.distributed`` group: NCCL on the card, gloo only when the
caller asks for the CPU.  It is called before any mesh is built.

Elastic restarts: the coordinator address is stable across restarts
(node 0); a restarted job initializes with a possibly different process
count and the checkpoint layer reshapes (checkpoints hold logical
arrays, ``checkpoint/ckpt.py``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core.graph import resolve_device


def coordinator_from_env(env=None):
    """``(host:port, num_processes, process_id)`` from the launcher's
    environment, or None when no coordinator is named.  ``REPRO_*``
    first; under SLURM, node 0 of the allocation at port 8476."""
    env = os.environ if env is None else env
    coord = env.get("REPRO_COORDINATOR")             # host:port
    if coord is None and "SLURM_JOB_NODELIST" in env:
        # SLURM: node 0 of the allocation is the coordinator
        first = env["SLURM_JOB_NODELIST"].split(",")[0]
        first = first.split("[")[0] + env.get("SLURM_NODELIST_SUFFIX", "")
        coord = f"{first}:8476"
    if coord is None:
        return None
    num_procs = int(env.get("REPRO_NUM_PROCESSES",
                            env.get("SLURM_NTASKS", "1")))
    proc_id = int(env.get("REPRO_PROCESS_ID", env.get("SLURM_PROCID", "0")))
    return coord, num_procs, proc_id


def maybe_initialize_distributed(device=None) -> bool:
    """Join this process to the job's group from the environment; True
    when a group was set up, False when no coordinator is set (one
    process, nothing done).  ``device``: cuda unless the caller names
    another; on cuda the group is NCCL and this process's card is
    ``process_id % device_count``, on the CPU the group is gloo."""
    found = coordinator_from_env()
    if found is None:
        return False
    coord, num_procs, proc_id = found
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(proc_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=num_procs, rank=proc_id)
    return True


def global_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch this process owns (a pure function of
    its rank: replay-safe across restarts)."""
    nproc, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    assert global_batch % nproc == 0, (global_batch, nproc)
    per = global_batch // nproc
    return slice(rank * per, rank * per + per)
