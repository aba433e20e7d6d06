"""The sequence group: ranks that split one long sequence between them.

Counterpart of the ``seq`` axis of ``vnsum_tpu/parallel/mesh.py`` (``AXES``,
``axis_size``). The JAX package names a mesh axis and lets ``shard_map``
and ``pmax``/``psum``/``ppermute`` run the collectives over it; here a
:class:`SeqGroup` holds the rank, the world size and a
``torch.distributed`` process group, and runs the same three collectives
itself: max and sum all-reduce, and a ring shift to the next rank.

A group of one rank needs no process group, and every collective is then
the identity. Larger groups run over gloo on the CPU and over NCCL on
cards, one card per rank. The class serves every mesh axis: a
:class:`..parallel.mesh.Mesh` holds one for each of its ``data``, ``model``
and ``seq`` axes, whose process group is the mesh's group along that axis;
its ranks are then the axis coordinates, and the collectives map them to
the global ranks ``torch.distributed`` addresses.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class SeqGroup:
    rank: int = 0
    world: int = 1
    # None with world 1; else the process group the collectives run over
    # (its ranks are 0..world-1, the seq ranks)
    group: object = None

    def __post_init__(self) -> None:
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a seq group of {self.world}")
        if self.world > 1 and self.group is None:
            raise ValueError("a seq group of more than one rank needs a process group")

    @classmethod
    def init(
        cls, rank: int, world: int, init_method: str, *, device="cuda", timeout_s: float = 300.0
    ) -> "SeqGroup":
        """Join a seq group of ``world`` ranks as ``rank``: gloo for
        ``device`` "cpu", NCCL with this rank's card (``cuda:rank``) for
        "cuda". ``init_method`` is a ``tcp://host:port`` or ``file://``
        rendezvous. Raises when this rank has no card or the group cannot
        form within ``timeout_s``."""
        if world == 1:
            return cls()
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available() or torch.cuda.device_count() <= rank:
                raise RuntimeError(
                    f"seq rank {rank} needs card cuda:{rank}, but "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                    "CUDA cards are visible"
                )
            torch.cuda.set_device(rank)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"no seq group backend for device {dev}")
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        return cls(rank, world, dist.group.WORLD)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the group (``pmax``); in place, returned."""
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the group (``psum``); in place, returned."""
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def _global(self, rank: int) -> int:
        """The global rank of this group's ``rank``, which is what the
        collectives' ``src`` and peer arguments name."""
        return dist.get_global_rank(self.group, rank)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the next rank and return the previous rank's
        (``ppermute`` with perm j -> j + 1 mod world). gloo's point-to-point
        ops take host tensors only (its collectives copy CUDA tensors
        themselves), so a CUDA tensor goes through the host there: ranks
        sharing one card over gloo."""
        if self.world == 1:
            return t
        if t.is_cuda and dist.get_backend(self.group) == "gloo":
            return self.ring_shift(t.cpu()).to(t.device)
        send = t.contiguous()
        recv = torch.empty_like(send)
        nxt, prv = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        ops = [
            dist.P2POp(dist.isend, send, self._global(nxt), self.group),
            dist.P2POp(dist.irecv, recv, self._global(prv), self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank; in place, returned."""
        if self.world > 1:
            dist.broadcast(t, src=self._global(src), group=self.group)
        return t

    def reduce_sum(self, t: torch.Tensor, dst: int) -> torch.Tensor:
        """Elementwise sum over the group onto rank ``dst``: in place there,
        returned (elsewhere ``t`` is left undefined). gloo's reduce takes
        host tensors only, so a CUDA tensor goes through the host there."""
        if self.world == 1:
            return t
        if t.is_cuda and dist.get_backend(self.group) == "gloo":
            return t.copy_(self.reduce_sum(t.cpu(), dst))
        dist.reduce(t, dst=self._global(dst), op=dist.ReduceOp.SUM, group=self.group)
        return t

    def close(self) -> None:
        """Leave the group (destroys the default process group)."""
        if self.world > 1 and dist.is_initialized():
            dist.destroy_process_group()
