"""Process-group initialization and cross-process helpers.

The port of `deep_spectral_tpu.parallel.distributed`. The JAX package is
single-controller: `jax.distributed.initialize` joins hosts, after which
every program spans all devices. The port is SPMD instead: one process per
device under `torch.distributed`, NCCL between CUDA devices and gloo on the
CPU. These helpers wrap the group's setup and the few host-level utilities
the tasks need (master detection, metric sums across processes, a sync
point).

Launch: `torchrun --nproc_per_node=<gpus> <script>` sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT, which `initialize()` reads; or pass
the address (`tcp://host:port`), the world size and the rank.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device_type: str = "cuda") -> bool:
    """Join a process group: NCCL for device_type 'cuda', gloo for 'cpu'.

    Rank and world come from the arguments or, without them, from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). One process
    with neither has nothing to join and returns False, as the JAX version
    does; an initialized group is left as it is. On CUDA the process takes
    the device LOCAL_RANK (else rank modulo the device count) as its current
    device; with no card it raises RuntimeError, and nothing falls back to
    gloo or the CPU. Returns True when a group is up."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return False
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    resolve_device(device_type, "parallel.distributed.initialize")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
        init = dict(init_method=coordinator_address, rank=rank, world_size=world)
    else:
        rank, init = int(os.environ["RANK"]), {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", **init)
    return True


def process_index() -> int:
    """This process's rank (0 with no group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 with no group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return process_index() == 0


def _host_device() -> torch.device:
    """Where a collective's host-side scalar goes: NCCL reduces only CUDA
    tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_sum_host(values) -> list[float]:
    """Sum a list of host numbers across processes, in float64, with one
    all-reduce."""
    if process_count() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_host_device())
    dist.all_reduce(t)
    return t.tolist()


def all_sum_scalar(x: float) -> float:
    """Sum a host scalar across processes, in float64 (metric sync; the
    reference's dist.all_reduce at object-segmentation/util.py:117-119)."""
    return all_sum_host([x])[0]


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point (the reference's
    accelerator.wait_for_everyone, extract/extract.py:114). `name` labels
    the point, as in the JAX version; the group's barrier is unnamed."""
    del name
    if process_count() > 1:
        dist.barrier()


class _AllSum(torch.autograd.Function):
    """Sum over the group's ranks, whose gradient is the sum of the ranks'
    gradients (`dist.all_reduce` in place records none)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_sum_differentiable(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks of `group`, with autograd: each rank's
    gradient of x is the sum of every rank's gradient of the result."""
    return _AllSum.apply(x, group)
