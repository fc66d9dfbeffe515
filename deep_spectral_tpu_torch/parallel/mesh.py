"""Device meshes and the moves between whole tensors and a rank's block.

The port of `deep_spectral_tpu.parallel.mesh`. JAX places a global array
on a `Mesh` by a `NamedSharding`, and XLA inserts the collectives. The port
is SPMD: each process holds one device and its own block, a
`torch.distributed.device_mesh.DeviceMesh` names the dims ('data' and
'model', as in the JAX package), and the collectives are explicit. The JAX
shardings map to:
  * `batch_sharding` / `row_sharding` -> `local_rows` (this rank's block of
    rows along a mesh dim), and `gather_rows` (the blocks of every rank of
    the dim, put back in rank order);
  * `replicate_sharding` -> `replicate` (rank 0's tensor of the dim, on
    every rank of it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[tuple[str, int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the process group (`distributed.initialize` first), one
    device per process. Default: 1-D ('data', world). Pass axes=[('data', a),
    ('model', b)] for a 2-D mesh; a*b must equal the world size, and the
    ranks fill the mesh row-major, as the JAX mesh reshapes its devices.
    device_type 'cuda' (the default) raises RuntimeError without a card;
    pass 'cpu' for a gloo group on the CPU."""
    resolve_device(device_type, "make_mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"mesh of {n} devices != world size {world} "
                         "(one device per process)")
    if axes is None:
        axes = [(DATA_AXIS, n)]
    names = tuple(a[0] for a in axes)
    shape = tuple(int(a[1]) for a in axes)
    if int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh {list(shape)} != {n} devices")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_group(mesh, axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of `axis`: a DeviceMesh's dim by name, a group as
    given, None (the default group) for None."""
    if isinstance(mesh, DeviceMesh):
        if axis not in mesh.mesh_dim_names:
            raise KeyError(f"mesh has dims {mesh.mesh_dim_names}, not {axis!r}")
        return mesh.get_group(axis)
    return mesh


def local_rows(group, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of x along `dim`, whose size must divide by the
    group's size (pad with masked rows)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible by {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


def gather_rows(group, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's block of the group, concatenated along `dim` in rank
    order, on every rank (blocks of one shape)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def replicate(group, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Group rank `src`'s x on every rank of the group (x of the same shape
    and dtype on each; overwritten in place elsewhere)."""
    if dist.get_world_size(group) > 1:
        dist.broadcast(x, dist.get_global_rank(group, src) if group is not None else src,
                       group=group)
    return x


def require_dino_v1(cfg, what: str) -> None:
    """Raise ValueError unless `cfg` (a `ViTConfig`) is a DINO v1 ViT. The
    sequence-, pipeline- and tensor-parallel forwards size a batch's rows
    as CLS plus patches and (SP, TP) run a block piece by piece, without
    register or storage tokens, LayerScale or RoPE: a DINOv2 or DINOv3
    model would run with wrong features and no error."""
    if cfg.family != "dino":
        raise ValueError(f"{what} runs DINO v1 ViTs only; got the {cfg.family!r} family")
