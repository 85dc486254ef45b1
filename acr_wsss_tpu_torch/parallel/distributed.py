"""Process-group start-up: one process per GPU.

Counterpart of ``acr_wsss_tpu/parallel/distributed.py``. JAX runs one
controller per host that drives every local chip, and
``jax.distributed.initialize`` joins the hosts. PyTorch runs one process
per GPU, which a launcher starts (``torchrun``, or a spawn) with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in its environment, as the reference's DDP trainer is
started (``train_acr.py:70-99``). :func:`initialize` joins those
processes into the default process group, over NCCL for CUDA devices and
gloo for the CPU; without a launcher's environment it does nothing, and
the process trains alone on one device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher started this process as one rank of several
    (``RANK`` and ``WORLD_SIZE`` set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def require_launcher() -> None:
    """``--multihost``: fail unless the launcher's environment is there."""
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing and not dist.is_initialized():
        raise RuntimeError(
            f"--multihost needs the environment a launcher sets for each rank "
            f"({', '.join(LAUNCHER_ENV)}); missing {', '.join(missing)}. Start the "
            "trainer with torchrun (--nnodes, --node_rank, --rdzv_endpoint across "
            "nodes), or drop --multihost to train in one process")


def local_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA device named
    without an index, the device itself otherwise. A rank that finds no
    GPU, or fewer GPUs than its local rank, fails: it does not carry on on
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass --device cpu to run on the CPU")
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} requested but only {torch.cuda.device_count()} "
                           "CUDA devices are visible")
    return device


def initialize(device="cuda", init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the default process group; True when one is up.

    Rank and world size come from the arguments or else from the
    launcher's environment; with neither, and no group yet, this is a
    no-op (one process) and returns False. ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``); a ``file://`` store
    needs no port. The backend is NCCL on a CUDA device and gloo on the
    CPU unless given. A failed start raises."""
    if dist.is_initialized():
        return True
    if rank is None and world_size is None and not launched():
        return False
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return True


def rank() -> int:
    """This process's rank in the default group; the launcher's ``RANK``
    before the group is up; 0 for a lone process."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
