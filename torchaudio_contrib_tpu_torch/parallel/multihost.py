"""Multi-process setup: the process group and the pod-wide mesh.

Port of ``torchaudio_contrib_tpu/parallel/multihost.py``.  One process per
GPU; ``torchrun --nnodes=H --nproc_per_node=G script.py`` sets
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``, and
the JAX package's names (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/
``PROCESS_ID``) are read as well.  The mesh keeps the ``model`` axis within
a host (NVLink) and lets ``data`` span hosts, as the JAX layout keeps
``model`` on ICI.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .sharding import make_mesh

__all__ = ["initialize_multihost", "make_pod_mesh"]


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda", timeout=None) -> None:
    """Start the process group (idempotent; nothing for one process).

    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` /
    ``file://`` init method); by default ``COORDINATOR_ADDRESS``, else
    ``MASTER_ADDR:MASTER_PORT``.  ``num_processes``/``process_id`` default
    to ``NUM_PROCESSES``/``PROCESS_ID``, else ``WORLD_SIZE``/``RANK``.  The
    backend is NCCL for ``device="cuda"`` (each process takes the GPU
    ``LOCAL_RANK``) and gloo for the CPU.
    """
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs a coordinator address "
                         "and this process's id")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    device_type = torch.device(device).type
    if device_type == "cuda":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id, **kwargs)


def make_pod_mesh(n_model: int = 1, *, device="cuda") -> DeviceMesh:
    """``(data, model)`` mesh over every rank of the group: consecutive
    ranks (one host's, as the launchers number them) share ``model``."""
    if dist.is_initialized():
        n = dist.get_world_size()
        if n % n_model != 0:
            raise ValueError(
                f"{n} devices not divisible by n_model={n_model}")
    return make_mesh(n_model=n_model, device=device)
