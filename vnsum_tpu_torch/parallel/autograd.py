"""The two collectives of a tensor-parallel training step, as autograd sees them.

The JAX package differentiates its sharded step through GSPMD, which puts
the gradient's collectives where the forward's imply them. The port writes
the forward's collectives out (``models/llama.py``), and an in-place
``dist.all_reduce`` is invisible to autograd, so the training forward
brackets each sharded region with Megatron's two operators instead:

- :func:`copy_to_group` (Megatron's *f*): the identity forward, a sum
  all-reduce of the gradient backward. It goes on each replicated input of
  a sharded computation (the normed ``h`` before q/k/v and before
  gate/up, the final norm's output before the vocab-sliced head, a
  replicated weight applied to local heads), whose gradient each rank
  holds only in part;
- :func:`reduce_from_group` (Megatron's *g*): a sum all-reduce forward,
  the identity backward. It goes where the inference forward sums partial
  products (after ``wo`` and ``w_down``, the embedding, the logits), and
  on the loss over ``data``.

``torch.distributed.nn.functional.all_reduce`` is not *g*: its backward
all-reduces the gradient too, which, with every rank of the group holding
the same replicated loss, multiplies it by the group's size.

On a group of one rank both are the identity and add no autograd node.
:class:`DifferentiableGroup` hands *g* to the functions that take a group
and call its ``all_reduce_sum`` (``embed_lookup``, ``lm_head_logits``), so
the inference forward and the training forward share them.

ZeRO-3 over an ``fsdp`` axis adds a third, :func:`gather_layer`: the
forward broadcasts one layer's weights from the rank that owns them, the
backward sums the layer's gradient onto that rank. GSPMD all-gathers the
layer and reduce-scatters its gradient; with one owner a layer, the
gather is the owner's broadcast and the scatter a reduce onto it.
"""
from __future__ import annotations

import torch

from .seq import SeqGroup

__all__ = ["DifferentiableGroup", "copy_to_group", "gather_layer", "reduce_from_group"]


def _summed(t: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """A contiguous copy of ``t`` summed over ``group`` (``t`` is untouched)."""
    return group.all_reduce_sum(t.clone(memory_format=torch.contiguous_format))


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """*f*: ``x`` itself forward; backward, the gradient summed over
    ``group``. Collective in the backward: every rank of the group runs it."""
    if group.world == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """*g*: ``x`` summed over ``group`` forward (a new tensor); backward,
    the gradient passed through. Collective: every rank of the group runs
    it."""
    if group.world == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


class _GatherLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, owner, group):
        ctx.owner, ctx.group = owner, group
        if group.rank == owner:
            buf = w.clone(memory_format=torch.contiguous_format)
        else:
            buf = torch.empty_like(w, memory_format=torch.contiguous_format)
        return group.broadcast(buf, owner)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.group.reduce_sum(grad.clone(memory_format=torch.contiguous_format), ctx.owner)
        # the owner's layer takes the sum; elsewhere ``w`` is another layer
        return (total if ctx.group.rank == ctx.owner else None), None, None


def gather_layer(w: torch.Tensor, owner: int, group: SeqGroup) -> torch.Tensor:
    """One layer's weight, whole on every rank of the ``fsdp`` ``group``:
    rank ``owner``'s ``w`` broadcast forward; backward, the gradient summed
    onto ``owner``, and dropped elsewhere. Every rank passes its own layer
    at the same local index, which gives the shape and ties the backward
    in. Collective both ways: every rank of the group runs it."""
    if group.world == 1:
        return w
    return _GatherLayer.apply(w, owner, group)


class DifferentiableGroup:
    """``group`` with ``all_reduce_sum`` as *g*: the sum over the group that
    autograd differentiates as the identity. ``rank`` and ``world`` are the
    group's."""

    def __init__(self, group: SeqGroup) -> None:
        self.group, self.rank, self.world = group, group.rank, group.world

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return reduce_from_group(t, self.group)
