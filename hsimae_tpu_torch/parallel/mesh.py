"""Process groups, the (data, model) device mesh and the batch split.

Counterpart of ``hsimae_tpu/parallel/mesh.py``. The JAX package runs one
process over many devices and lets XLA insert the collectives; PyTorch runs
one process per rank, so here:

* :func:`init_distributed` joins the process group from the environment
  that ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
  arguments, and returns the rank's device: ``cuda:{local_rank % cards}``,
  or the CPU when asked. The backend is fixed by the layout: ``nccl`` when
  every rank of a host has a card of its own, ``gloo`` when ranks share a
  card or run on the CPU (NCCL refuses two ranks on one device);
* :func:`make_mesh` is a ``DeviceMesh`` over the whole group with dims
  ``("data", "model")``; ``mesh["data"]`` and ``mesh["model"]`` play the
  part of the JAX mesh axes;
* every rank computes the same seeded epoch permutation and gathers only
  its contiguous rows of each global batch (:func:`process_local_slice`,
  :func:`shard_batch`) from its own resident copy of the scenes, which is
  the JAX package's multi-host path;
* :func:`replicate` broadcasts a model's parameters and buffers and an
  optimizer's moments from the first rank of the data axis;
  :func:`all_reduce_grads` sums the gradients over the data axis in one
  flat buffer per dtype; :func:`global_sum` and :func:`all_gather_rows`
  are the two other collectives the loops need.

Every collective here runs on the data axis's group and on the tensors'
own device (gloo takes CUDA tensors as they are).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the process group is one per process, and so is what is kept about it: the
# device init_distributed chose (make_mesh's device type), and default_mesh's
# mesh with the group it was built over (building one is a collective)
_DEVICE: Optional[torch.device] = None
_DEFAULT_MESH = None


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return default if v is None else int(v)


def backend_for(device_type: str, local_world_size: int) -> str:
    """``nccl`` when each of the host's ``local_world_size`` ranks has a
    card of its own, else ``gloo`` (ranks that share a card, or the CPU)."""
    if device_type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                     init_method: Optional[str] = None, local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     device: str | torch.device = "cuda") -> torch.device:
    """Join the default process group (once) and return this rank's device.

    Arguments not given come from the environment ``torch.distributed.run``
    sets; ``init_method`` defaults to ``env://``. ``device`` names the
    device type (``cuda`` or ``cpu``); a CUDA rank takes card
    ``local_rank % torch.cuda.device_count()``. Rank 0 prints the backend."""
    global _DEVICE
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", world_size)
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        backend = backend_for(dev_type, local_world_size)
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
        if rank == 0:
            print(f"[parallel] {world_size} ranks, backend {backend}, {dev_type}", flush=True)
    _DEVICE = dev
    return dev


def shutdown_distributed() -> None:
    """Leave the default process group, if this process joined one."""
    global _DEVICE, _DEFAULT_MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = _DEFAULT_MESH = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or no process group: the rank that logs and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def make_mesh(data: int = -1, model: int = 1, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``(data, model)`` over the whole process
    group, dims named ``("data", "model")``; ``data=-1`` takes the ranks
    ``model`` leaves. ``device_type`` defaults to the type of the device
    :func:`init_distributed` chose (else ``cuda`` when a card is present)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"{n} ranks do not divide into model={model}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover the {n} ranks")
    if device_type is None:
        device_type = _DEVICE.type if _DEVICE is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def default_mesh():
    """The data-parallel mesh over every rank when a process group is up
    (of one rank too, as ``torch.distributed.run --nproc-per-node 1`` starts
    it: its collectives then run), else None: the loops' counterpart of the
    JAX package's mesh over every visible device. Built once a group."""
    global _DEFAULT_MESH
    if not dist.is_initialized():
        return None
    if _DEFAULT_MESH is None or _DEFAULT_MESH[0] is not dist.group.WORLD:
        _DEFAULT_MESH = (dist.group.WORLD, make_mesh())
    return _DEFAULT_MESH[1]


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def process_local_slice(n: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """Rows of a length-``n`` global batch owned by data rank
    ``process_index`` of ``process_count``: ``[p*n//P, (p+1)*n//P)``.
    Defaults: this process's rank and the group's size (``slice(0, n)``
    without a group)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = world_size()
    return slice(process_index * n // process_count, (process_index + 1) * n // process_count)


def mesh_slice(n: int, mesh) -> slice:
    """This rank's rows of a length-``n`` global batch on ``mesh``'s data
    axis (all of them without a mesh)."""
    if mesh is None:
        return slice(0, n)
    return process_local_slice(n, mesh.get_local_rank("data"), data_size(mesh))


def shard_batch(batch, mesh, device: Optional[torch.device] = None):
    """This rank's rows of a global batch (a tensor, or a tuple, list or dict
    of tensors, each with the batch leading and divisible by the data axis),
    on ``device`` (default: this rank's device on ``mesh``)."""
    device = device if device is not None else mesh_device(mesh)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh, device) for v in batch)
    if batch.shape[0] % data_size(mesh):
        raise ValueError(f"batch of {batch.shape[0]} does not divide over "
                         f"data={data_size(mesh)}")
    return torch.as_tensor(batch)[mesh_slice(batch.shape[0], mesh)].to(device)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_mesh_info(mesh) -> str:
    if mesh is None:
        return "no mesh (single device)"
    return (f"mesh data={mesh.size(0)} model={mesh.size(1)} on {mesh.size()} "
            f"{mesh.device_type} ranks")


# ------------------------------ collectives ---------------------------------


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The shard this rank holds of a ``DTensor`` (tensor parallelism), or
    ``t`` itself; in-place writes reach the parameter."""
    return getattr(t, "_local_tensor", t)


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """Run ``op(flat)`` on one flat buffer per dtype of ``tensors`` and copy
    the result back into them."""
    for group in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh, optimizer=None) -> None:
    """Broadcast ``model``'s parameters and buffers (and ``optimizer``'s
    moments and update count) from the first rank of the data axis to the
    others, one flat buffer per dtype. A tensor-parallel parameter sends
    its own shard along the data axis."""
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    tensors = [local_tensor(t) for t in (*model.parameters(), *model.buffers())]
    count = None
    if optimizer is not None:
        for moments in (*optimizer.mu, *optimizer.nu):
            tensors += [local_tensor(m) for m in moments]
        count = torch.tensor([optimizer.count], dtype=torch.int64, device=tensors[0].device)
        tensors.append(count)
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))
    if optimizer is not None:
        optimizer.count = int(count.item())


@torch.no_grad()
def all_reduce_grads(model: torch.nn.Module, mesh, *scalars: torch.Tensor) -> List[torch.Tensor]:
    """Sum every parameter's gradient over the data axis, in one all-reduce
    of a flat buffer per dtype, and with them ``scalars`` (0-d float32
    tensors, e.g. the rank's share of the loss); returns the summed
    scalars."""
    sums = [s.detach().float().reshape(1).clone() for s in scalars]
    if mesh is None:
        return [s[0] for s in sums]
    grads = [local_tensor(p.grad) for p in model.parameters() if p.grad is not None]
    group = mesh.get_group("data")
    _flat_collective(grads + sums, lambda flat: dist.all_reduce(flat, group=group))
    return [s[0] for s in sums]


def global_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the data axis (a new tensor; ``t`` without a mesh)."""
    if mesh is None:
        return t
    out = t.clone()
    dist.all_reduce(out, group=mesh.get_group("data"))
    return out


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """``[data, *t.shape]``: every data rank's ``t`` (the same shape on
    each), in data-axis order."""
    if mesh is None:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(data_size(mesh))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("data"))
    return torch.stack(parts)
