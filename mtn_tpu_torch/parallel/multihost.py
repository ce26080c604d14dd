"""Joining the ranks of a multi-process run (``mtn_tpu/parallel/
multihost.py``), with the same ``--multihost`` grammar: ``auto`` or
``host:port,nprocs,procid``.

``auto`` reads ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the counterpart of
JAX's self-detection on a pod. The backend is NCCL for a CUDA device and
gloo for the CPU; ``backend=`` overrides it (two ranks on one card must
use gloo: NCCL puts at most one rank on a device). Each rank's device is
``cuda:{local_rank % device_count}``.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize(coordinator: str = "auto", num_processes: int = -1,
               process_id: int = -1, device: str = "cuda",
               backend: str = "") -> torch.device:
    """Join the process group; returns this rank's device (``device``'s
    type; a CUDA device gets this rank's index)."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if coordinator == "auto":
        dist.init_process_group(backend, init_method="env://")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        local = process_id
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    log.info("joined the process group: rank %d of %d, backend %s, "
             "device %s", dist.get_rank(), dist.get_world_size(),
             dist.get_backend(), dev)
    return dev


def initialize_from_flag(spec: str, device: str = "cuda",
                         backend: str = "") -> torch.device:
    """Parse the CLI ``--multihost`` flag: ``auto`` or
    ``coordinator_host:port,num_processes,process_id``."""
    if spec == "auto":
        return initialize(device=device, backend=backend)
    try:
        coord, nprocs, pid = spec.rsplit(",", 2)
        nprocs, pid = int(nprocs), int(pid)
    except ValueError as e:
        raise ValueError(
            f"--multihost expects 'auto' or 'host:port,nprocs,procid', "
            f"got {spec!r}") from e
    return initialize(coord, nprocs, pid, device=device, backend=backend)


def is_primary() -> bool:
    """Whether this process writes the run's files (rank 0, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
