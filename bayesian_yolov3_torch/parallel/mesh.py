"""Process groups for the multi-device axes, over ``torch.distributed``.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``.  Where JAX
builds a named mesh of devices that one program spans, here every device
is driven by a process of its own (a rank), and the ranks meet in
collectives of a process group:

* axis ``mc`` — the MC-dropout samples of epistemic inference, split over
  the ranks (``parallel/epistemic.py``);
* axis ``dp`` — the image batch of batched inference, split over the ranks
  (``parallel/batch.py``);
* axis ``sp`` — the image rows, split into one band per rank, with a
  one-row halo exchange around every 3x3 conv (``parallel/spatial.py``);
* axis ``data`` — the batch of data-parallel training, split over the
  ranks (``train/loop.py``): the BN batch statistics summed over the group
  through ``all_reduce_autograd``, the gradients averaged through
  ``Group.all_reduce_mean_packed``.

One axis spans the whole world (the default process group).  Two axes,
``{'sp': a, 'mc': b}``, lay the world out as the JAX package's
``make_mesh`` lays out its devices: the rank list reshaped to the axis
sizes in dict order, the first axis major, so rank = sp_idx * b + mc_idx;
each axis then runs over subgroups (``dist.new_group``) of the ranks that
share the other axis's index.

Bring-up: ``torchrun --nproc_per_node N`` sets ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` and ``maybe_initialize_from_config`` joins the group from
them; ``Config.coordinator_address`` (with ``num_processes`` and
``process_id``) names a ``tcp://`` rendezvous instead.  The backend is
``nccl`` for ranks on CUDA devices and ``gloo`` on the CPU unless the
caller names one: two ranks on ONE card need ``gloo`` (NCCL refuses two
ranks on one device).  Nothing here changes the backend or the device
because a collective failed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("byolo.mesh")


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device="cuda") -> None:
    """Join the default process group (``dist.init_process_group``).

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU.  ``init_method`` ``None`` reads torchrun's environment
    (``env://``).  On a CUDA device the device becomes the current one
    first, so NCCL binds the rank to it.  Raises if a group with another
    world size or rank is already initialised."""
    if dist.is_initialized():
        if ((world_size is not None and dist.get_world_size() != world_size)
                or (rank is not None and dist.get_rank() != rank)):
            raise RuntimeError(
                f"a process group of world size {dist.get_world_size()} (rank "
                f"{dist.get_rank()}) is already initialised; asked for world size "
                f"{world_size}, rank {rank}")
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    log.info("joined process group: rank %d of %d (%s)", dist.get_rank(),
             dist.get_world_size(), dist.get_backend())


def maybe_initialize_from_config(config, device="cuda") -> bool:
    """Join the process group that the configuration or torchrun names:
    ``config.coordinator_address`` (host:port; world size
    ``config.num_processes``, rank ``config.process_id``) if set, else
    torchrun's ``RANK`` / ``WORLD_SIZE`` environment if present.  Returns
    True when the process runs in a group, False for a single process."""
    if dist.is_initialized():
        return True
    if config.coordinator_address:
        addr = config.coordinator_address
        initialize_distributed(
            None, addr if "://" in addr else f"tcp://{addr}",
            world_size=config.num_processes, rank=config.process_id, device=device)
        return True
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        initialize_distributed(None, "env://", device=device)
        return True
    return False


def local_rank() -> int:
    """The rank's index among the ranks of its host (torchrun's LOCAL_RANK;
    0 for a single process)."""
    return int(os.environ.get("LOCAL_RANK", 0))


@dataclasses.dataclass(frozen=True)
class Group:
    """One axis of ranks: its size, this process's rank on it, and the
    process group its collectives run over (None: the default group, the
    whole world)."""

    size: int
    rank: int
    pg: Optional[dist.ProcessGroup] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group's ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.pg)
        return torch.cat(parts, dim=dim)

    def exchange_edges(self, first: Optional[torch.Tensor], last: torch.Tensor):
        """The halo exchange of the ``sp`` axis: every rank offers the first
        and the last row of its band (``first`` None: the last alone) and
        gets ``(prev_last, next_first)`` — the previous rank's ``last`` and
        the next rank's ``first`` — with None past either end of the axis
        (and for ``next_first`` when ``first`` is None).  One all-gather of
        the edges within the group: NCCL and gloo both take it for CUDA
        tensors, where gloo has no point-to-point send for them."""
        edges = last[None] if first is None else torch.stack([first, last])
        got = self.all_gather(edges[None], dim=0)  # (size, 1 or 2, ...)
        prev_last = got[self.rank - 1, -1] if self.rank > 0 else None
        next_first = (got[self.rank + 1, 0] if first is not None and self.rank < self.size - 1
                      else None)
        return prev_last, next_first

    def all_reduce_autograd(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group's ranks, out of place, with a gradient:
        the backward all-reduces the incoming gradient (``_AllReduceSum``)."""
        return _AllReduceSum.apply(t, self.pg)

    def all_reduce_mean_packed(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the group's ranks of each of ``tensors``, through
        ONE all-reduce of one float32 buffer that holds them all flattened
        (one call where one a tensor would pay the collective's latency per
        leaf); the results in the tensors' shapes and dtypes."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.pg)
        flat.div_(self.size)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.pg)

    def all_true(self, flag: bool, device) -> bool:
        """True iff ``flag`` holds on every rank of the group."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return int(t.item()) == self.size


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over the ranks of x`` with ``dx = sum over the ranks of
    dy``: each rank's loss depends on every rank's ``x`` through ``y``, and
    the sum of the ranks' gradients is then the gradient of the summed loss.
    Written here so that it does not depend on the torch version's
    ``torch.distributed.nn``."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=pg)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.pg)
        return dx, None


def world_group() -> Group:
    """Every rank of the initialised default process group, as one group."""
    return Group(size=dist.get_world_size(), rank=dist.get_rank())


def make_groups(shape: Dict[str, int]) -> Dict[str, Group]:
    """This rank's group on each axis of ``shape`` (``{'mc': N}``,
    ``{'data': N}``, ``{'sp': a, 'mc': b}``, ...), whose sizes multiply to
    the world size of the initialised default process group (the JAX
    package's ``make_mesh`` asserts the same), else ``RuntimeError``.  One axis spans the whole
    world.  Several lay the ranks out row-major over the axes in dict
    order; every rank builds every subgroup, in one fixed order (axis by
    axis, lines in rank order), as ``dist.new_group`` requires."""
    world = int(np.prod(list(shape.values())))
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh_shape {shape} needs an initialised process group of world size {world}: "
            "none is (run under torchrun, set coordinator_address, or call "
            "parallel.initialize_distributed first)")
    if dist.get_world_size() != world:
        raise RuntimeError(
            f"mesh_shape {shape} needs an initialised process group of world size {world}; "
            f"this one has {dist.get_world_size()} ranks")
    if len(shape) == 1:
        return {name: world_group() for name in shape}
    me = dist.get_rank()
    layout = np.arange(world).reshape(list(shape.values()))
    groups = {}
    for axis, name in enumerate(shape):
        for line in np.moveaxis(layout, axis, -1).reshape(-1, shape[name]):
            pg = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = Group(size=len(line), rank=int(np.flatnonzero(line == me)[0]),
                                     pg=pg)
    return groups


def local_rows(table: np.ndarray, rank: int, n: int) -> np.ndarray:
    """Rank ``rank``'s share of a (T, ...) key table: rows
    [rank*T/n, (rank+1)*T/n) — the global samples that rank computes."""
    T = table.shape[0]
    if T % n:
        raise ValueError(f"T={T} does not divide over {n} ranks")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside [0, {n})")
    per = T // n
    return table[rank * per:(rank + 1) * per]
