"""Process-group set-up for data-parallel runs (counterpart of
`hosnerf_tpu/parallel/distributed.py`).

The reference trains with single-host NCCL DDP over 4 GPUs. Here one
process runs per card, as `torchrun --nproc_per_node N` starts them: each
rank steps on its share of every batch's rays (`parallel/mesh.py`), and
the steps reduce their gradients themselves. Where the JAX package
connects per-host processes with `jax.distributed.initialize`, this
module calls `torch.distributed.init_process_group`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               device=None) -> torch.device:
    """Join the process group and return this rank's device.

    Arguments left out are read from torchrun's environment:
    MASTER_ADDR and MASTER_PORT (the coordinator, `tcp://addr:port`),
    WORLD_SIZE, RANK, and LOCAL_RANK for the device; explicit arguments
    win. `coordinator_address` may also be an init method URL
    (`tcp://...`, `file://...`). One process without a coordinator is a
    no-op. `device`: the rank's device, `cuda:{LOCAL_RANK}` unless the
    caller names one ('cuda' names this rank's card; 'cpu' the CPU).
    `backend`: NCCL for a CUDA device, gloo for the CPU, unless named; a
    failed initialisation raises (nothing falls back to gloo)."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    dev = rank_device(device)
    if coordinator_address is None and num_processes in (None, 1):
        return dev                                   # one process
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return dev


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` as named, except that a CUDA device
    without an index becomes `cuda:{LOCAL_RANK}`; None means the card.
    Raises where a card is asked for and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (the CLI's "
                               "--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 (or no process group): the rank that writes logs,
    checkpoints, images and results."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
