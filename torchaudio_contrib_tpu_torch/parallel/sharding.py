"""Device meshes and batch-sharded transforms.

Port of ``torchaudio_contrib_tpu/parallel/sharding.py`` on
``torch.distributed``: a JAX ``Mesh`` becomes a
:class:`~torch.distributed.device_mesh.DeviceMesh` with the axes
``("data", "model")``, a ``NamedSharding`` becomes DTensor placements
(``Shard(0)`` on ``data``, ``Replicate()`` elsewhere), and a ``shard_map``
body becomes the code each rank runs on its own rows.

Every rank runs the same program (``torchrun`` or any launcher that sets up
the process group).  ``make_mesh()`` with no process group starts a group
of one rank in this process, so the one-card user's code is the same as a
multi-GPU run's (under ``torchrun`` its environment starts the group).
Ranks are placed on the card (``device="cuda"``, NCCL) unless the caller
asks for the CPU (gloo).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.utils import _pytree as pytree

from ._comm import as_sharded, axis_group, placements

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "sharded_apply",
    "data_parallel",
]


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _ensure_group(device_type: str) -> None:
    """The launcher's process group (``initialize_multihost``), else one of
    a single rank in this process."""
    from .multihost import initialize_multihost
    initialize_multihost(device=device_type)
    if dist.is_initialized():
        return
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[int]] = None, *,
              device="cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks of the process group.

    ``devices`` lists the global ranks to lay out (all of them by default);
    ``n_data`` defaults to ``len(devices) // n_model``.  ``device`` is the
    mesh's device type: ``"cuda"`` (NCCL) unless the caller asks for
    ``"cpu"`` (gloo).  With no process group, one of a single rank is
    started here.
    """
    device_type = torch.device(device).type
    _ensure_group(device_type)
    if devices is None:
        devices = list(range(dist.get_world_size()))
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} != {len(devices)} devices")
    layout = torch.tensor(devices, dtype=torch.int64).reshape(n_data,
                                                              n_model)
    return DeviceMesh(device_type, layout,
                      mesh_dim_names=("data", "model"))


def _check_batch(n: int, mesh: DeviceMesh) -> None:
    size = axis_group(mesh, "data")[2]
    if n % size:
        raise ValueError(
            f"batch {n} does not divide over the mesh's data axis "
            f"({size} ranks); pad the batch to a multiple of {size}")


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """``x (batch, ...)`` as a DTensor with its batch split over ``data``
    (the same ``x`` on every rank; rank 0's is what is kept)."""
    _check_batch(x.shape[0], mesh)
    return distribute_tensor(x, mesh, placements(mesh, "data", 0))


def replicate(x, mesh: DeviceMesh):
    """Replicate a pytree of tensors across the mesh (parameters, small
    constants) as DTensors."""
    placements = [Replicate()] * mesh.ndim
    return pytree.tree_map(
        lambda a: distribute_tensor(a, mesh, placements)
        if isinstance(a, torch.Tensor) else a, x)


def _local_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a batch: a DTensor's local shard, or the rank's
    slice of a tensor every rank holds whole."""
    if isinstance(x, DTensor):
        return x.to_local()
    _check_batch(x.shape[0], mesh)
    _, r, n = axis_group(mesh, "data")
    return x.chunk(n, 0)[r]


def sharded_apply(fn, mesh: DeviceMesh, donate: bool = False):
    """``fn(batch, ...)`` run on each rank's rows of ``batch`` (split over
    ``data``); returns the result as a DTensor sharded the same way.
    Feature extraction stays local to each rank (no collective).
    ``donate`` is ignored (it keeps the JAX signature): PyTorch frees the
    input when the caller drops it."""
    del donate

    def run(x, *args, **kwargs):
        return as_sharded(fn(_local_rows(x, mesh), *args, **kwargs), mesh,
                          "data", 0)

    return run


def data_parallel(transform, mesh: Optional[DeviceMesh] = None):
    """Wrap a transform (a module such as ``FusedMelspectrogram`` or any
    per-sample function) so that each rank runs it on its rows of the
    batch: the fused kernel runs per rank, as the JAX ``shard_map`` keeps
    the Pallas kernel per shard.  The batch must divide the mesh's ``data``
    axis.  Returns a ``Shard(0)`` DTensor.

    >>> mel = FusedMelspectrogram(num_mels=128, fft_length=2048)
    >>> out = data_parallel(mel)(waveforms)   # (B, C, mels, T), B sharded
    """
    if mesh is None:
        mesh = make_mesh()
    return sharded_apply(transform, mesh)
