"""Device mesh and sharding helpers over ``torch.distributed`` (port of
``tvc/parallel/mesh.py``).

The JAX package is single-controller: one process holds a ``Mesh`` of every
device and XLA inserts the collectives. The port is multi-controller: one
process per device, a ``DeviceMesh`` over the ranks of the process group,
and explicit collectives on the mesh's per-axis groups. Every rank calls an
entry point with the same global host inputs and gets the global result;
batch dims shard over the ``data`` axis, embedding banks keep only this
rank's row shard (:func:`bank_shard_axis`).

A mesh is built for the card unless the caller asks for the CPU. The card
runs NCCL; the CPU runs gloo. There is no fallback: a mesh larger than the
initialized group raises, a failed collective raises, and nothing gives way
to gloo or to one device by itself. Where a caller runs gloo ranks on CUDA
tensors (ranks sharing one card), :func:`all_gather` and :func:`all_reduce`
stage the tensor through host memory explicitly.

Launch one process per device with ``torchrun --nproc-per-node N`` (the
``env://`` rendezvous) or call :func:`initialize_multihost` with an
explicit coordinator, then :func:`create_mesh`. A single process with no
launcher gets a one-rank group, so :func:`create_mesh` there builds a mesh
over its one device, as the JAX package's does over the local devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: how long a rank waits in a collective before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh description (configs/default.yaml ``device.mesh``)."""

    axes: Tuple[str, ...] = (DATA_AXIS,)
    shape: Tuple[int, ...] = (-1,)  # -1 = all remaining devices

    def resolve_shape(self, n_devices: int) -> Tuple[int, ...]:
        shape = list(self.shape)
        known = int(np.prod([s for s in shape if s != -1])) if shape else 1
        if -1 in shape:
            if n_devices % max(known, 1) != 0:
                raise ValueError(
                    f"cannot infer mesh axis: {n_devices} devices not divisible by {known}"
                )
            shape[shape.index(-1)] = n_devices // max(known, 1)
        if int(np.prod(shape)) != n_devices:
            raise ValueError(
                f"mesh shape {tuple(shape)} does not cover {n_devices} devices"
            )
        return tuple(shape)


def _device_type(device: Optional[Union[str, torch.device]]) -> str:
    """``None`` means the card; without CUDA only an explicit CPU is taken."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a CPU mesh")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device}")
    return kind


def create_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[int]] = None,
    device: Optional[Union[str, torch.device]] = None,
):
    """A ``DeviceMesh`` over the ranks ``devices`` (default: every rank of
    the initialized group), shaped by ``config``. Every rank of the group
    calls it (building the per-axis groups is collective).

    ``device`` None is the card: each rank selects card ``local rank % card
    count`` unless it selected one already (``LOCAL_RANK`` under torchrun,
    else the global rank). ``device="cpu"`` builds a CPU mesh. A group not
    yet initialized is brought up by :func:`initialize_multihost` (a
    launcher's ``env://`` rendezvous, else one rank); the group must hold
    every rank of the mesh, otherwise this raises."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = _device_type(device)
    initialize_multihost(device=device)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if not ranks or max(ranks) >= world or min(ranks) < 0:
        raise RuntimeError(f"mesh ranks {ranks} are not all in the initialized group of {world}")
    config = config or MeshConfig()
    shape = config.resolve_shape(len(ranks))
    if kind == "cuda" and not torch.cuda.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(kind, layout, mesh_dim_names=tuple(config.axes))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}``, as ``jax.sharding.Mesh.shape`` reads."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh does not have."""
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``); 0
    for an axis the mesh does not have."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def mesh_device(mesh) -> torch.device:
    """The torch device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def bank_shard_axis(mesh) -> str:
    """The axis embedding-bank rows shard over, shared by EmbeddingBank and
    make_serving_step: 2D serving meshes put bank rows on MODEL_AXIS (batch
    rides DATA_AXIS); 1D data-only meshes use DATA_AXIS."""
    return MODEL_AXIS if MODEL_AXIS in mesh.mesh_dim_names else DATA_AXIS


def data_sharding(mesh, ndim: int = 1, axis: str = DATA_AXIS) -> Tuple[Any, ...]:
    """DTensor placements that shard the leading (batch) dim over ``axis``
    and replicate over every other mesh axis (``ndim`` is kept for the JAX
    signature: trailing dims are never sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh) -> Tuple[Any, ...]:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def shard_rows(x, mesh, axis: str = DATA_AXIS, dim: int = 0) -> Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` over ``axis``, as a
    tensor on the mesh's device (the size must divide)."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    n, k = axis_size(mesh, axis), axis_index(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} is not divisible by the {n} ranks of axis {axis!r}")
    g = t.shape[dim] // n
    return t.narrow(dim, k * g, g).contiguous().to(mesh_device(mesh))


def shard_batch(mesh, tree, axis: str = DATA_AXIS):
    """This rank's batch shard of a (nested dict / list / tuple) tree of host
    arrays, on the mesh's device. Batch sizes must be divisible by the axis
    size (pad with :func:`pad_to_multiple`)."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    return shard_rows(tree, mesh, axis)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


# ---------------------------------------------------------------------------
# collectives on one mesh axis
# ---------------------------------------------------------------------------


def _staged(t: Tensor, group) -> bool:
    """gloo ranks on CUDA tensors go through host memory, explicitly."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _host(t: Tensor) -> Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def all_gather(x: Tensor, mesh, axis: str, dim: int = 0) -> Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in the order of the
    ranks' coordinates on ``axis`` (``jax.lax.all_gather`` then a reshape).
    Shapes must agree across the axis."""
    if axis not in mesh.mesh_dim_names:
        return x
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.chunk(n)), src, group=group)
    out = out.to(x.device) if staged else out
    if dim:
        out = torch.cat(out.chunk(n), dim=dim)
    return out


def all_reduce(x: Tensor, mesh, axis: str) -> Tensor:
    """The sum of every rank's ``x`` over ``axis`` (a new tensor)."""
    if axis not in mesh.mesh_dim_names:
        return x
    group = mesh.get_group(axis)
    staged = _staged(x, group)
    buf = _host(x) if staged else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device) if staged else buf


def is_first_rank(mesh) -> bool:
    """Whether this rank is the mesh's first (the one that writes files)."""
    return int(mesh.mesh.flatten()[0]) == dist.get_rank()


def barrier(mesh) -> None:
    """Every rank of the mesh waits for every other: one small all_reduce
    on each axis in turn."""
    flag = torch.zeros(1, device=mesh_device(mesh))
    for axis in mesh.mesh_dim_names:
        all_reduce(flag, mesh, axis)
    if flag.is_cuda:
        torch.cuda.synchronize()


class _GatherWithGrad(torch.autograd.Function):
    """all_gather whose backward sums every rank's gradient of the gathered
    tensor and keeps this rank's block (a reduce-scatter, as all_reduce then
    a slice, which gloo also runs)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        k = axis_index(ctx.mesh, ctx.axis)
        full = all_reduce(grad.contiguous(), ctx.mesh, ctx.axis)
        return full[k * ctx.rows : (k + 1) * ctx.rows], None, None


def all_gather_with_grad(x: Tensor, mesh, axis: str) -> Tensor:
    """:func:`all_gather` along dim 0 with autograd through the gather."""
    if axis not in mesh.mesh_dim_names:
        return x
    return _GatherWithGrad.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# process group bring-up
# ---------------------------------------------------------------------------


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
) -> int:
    """Bring up the process group; returns its world size.

    ``coordinator_address``: ``host:port`` (a ``tcp://`` rendezvous) or a
    URL (``tcp://...``, ``file:///...``), with ``num_processes`` and
    ``process_id``; failures on this explicit path propagate. Without it the
    ``env://`` rendezvous of a launcher (``torchrun`` sets ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK``) is used when present; with no launcher
    environment this process is the only one, and a one-rank group comes up
    (a ``file://`` store in a new directory under the temporary directory).
    An already initialized group is a no-op.

    ``backend``: default NCCL for the card (``device`` None) and gloo for
    ``device="cpu"``; ``backend="gloo"`` on the card runs ranks that share a
    card (NCCL refuses two ranks on one device)."""
    if dist.is_initialized():
        return dist.get_world_size()
    kind = _device_type(device)
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if coordinator_address:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        dist.init_process_group(
            backend, init_method=url, world_size=int(num_processes), rank=int(process_id),
            timeout=COLLECTIVE_TIMEOUT,
        )
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        dist.init_process_group(backend, init_method="env://", timeout=COLLECTIVE_TIMEOUT)
    else:  # single process, no launcher
        store = os.path.join(tempfile.mkdtemp(prefix="tvc_rank_"), "store")
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=1, rank=0, timeout=COLLECTIVE_TIMEOUT,
        )
    return dist.get_world_size()


def host_local_batch(global_batch: int) -> int:
    """Per-process slice of a global batch (DistributedSampler role): one
    process per device, so the slice is over the world size."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def local_mesh_for_tests(
    n: int = 8,
    axes: Tuple[str, ...] = (DATA_AXIS,),
    device: Optional[Union[str, torch.device]] = None,
):
    """Mesh over the first ``n`` ranks of the group (tests / dry runs; a
    group not yet initialized is brought up as :func:`create_mesh` does);
    raises when the group has fewer."""
    have = initialize_multihost(device=device)
    if have < n:
        raise RuntimeError(f"need {n} ranks, have {have}")
    shape = (-1,) + (1,) * (len(axes) - 1)
    return create_mesh(MeshConfig(axes=axes, shape=shape), list(range(n)), device=device)
