"""Sharded training step (fine-tuning / continued pretraining of the
summarization model).

Counterpart of ``vnsum_tpu/train/trainer.py``. The JAX package runs one
jit-compiled step over a ``(data, model, seq[, fsdp])`` mesh and lets GSPMD
place the collectives. The port runs the usual PyTorch SPMD layout
instead, one process per card, every rank running the same step:

- ``data``: each rank takes its rows of the global batch
  (``parallel/sharding.py`` ``data_rows``); the loss is the mean over the
  whole batch's unmasked positions (:func:`lm_loss`), and the gradients are
  summed over ``data`` before the update;
- ``model``: each rank holds its shard of the weights (``param_specs``)
  and runs the tensor-parallel forward with Megatron's *f* and *g*
  (``parallel/autograd.py``), so every rank computes the same loss and
  its own shard's gradient;
- ``fsdp`` with ``TrainConfig(fsdp=True)`` (ZeRO-3): each rank holds
  ``n_layers / fsdp`` of the stacked layers and their moments
  (``shard_params(fsdp=True)``); each block gathers its layer from the
  owner and sums the layer's gradient back onto it
  (``parallel/autograd.py`` ``gather_layer``); the batch's rows shard over
  ``(data, fsdp)``, so the fsdp ranks also split the compute, as the JAX
  trainer's do;
- ``seq`` with ``TrainConfig(context_parallel=True)``: each rank runs its
  slice of the sequence, attention over the whole of it by the
  differentiable ring (``parallel/ring.py`` ``ring_attention_fn``), and
  the gradients are summed over ``seq`` too;
- the update is optax's ``clip_by_global_norm`` then ``adamw``, in optax's
  order (:class:`AdamW`), on parameters and moments the trainer owns;
- each block is recomputed in the backward pass (``remat``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import torch

from ..core.logging import get_logger
from ..models.llama import LlamaConfig, LlamaModel, forward_train, init_params, params_from_numpy
from ..parallel.autograd import reduce_from_group
from ..parallel.mesh import AXES, Mesh, mesh_device
from ..parallel.ring import ring_attention_fn
from ..parallel.seq import SeqGroup
from ..parallel.sharding import batch_rows, param_specs, shard_params

logger = get_logger("vnsum.train")


def lm_loss(
    model: LlamaModel,
    tokens: torch.Tensor,      # [B, S]
    loss_mask: torch.Tensor,   # [B, S] bool — positions whose NEXT token counts
    *,
    attention_fn=None,
    remat: bool = True,
    data: SeqGroup | tuple[SeqGroup, ...] | None = None,
    seq: SeqGroup | None = None,
) -> torch.Tensor:
    """Next-token cross-entropy, mean over the unmasked positions of the
    whole batch.

    With ``data`` groups of more than one rank (``data``, and ``fsdp``
    under ZeRO-3), ``tokens`` and ``loss_mask`` are this rank's rows of the
    batch: the count of unmasked positions is summed over the groups, and
    so is the rank's share of the loss (*g*: the sum forward, the identity
    backward). Every rank then returns the global mean, and its gradient
    is its own rows' part of the global mean's gradient, which the trainer
    sums over the groups. Averaging each rank's own mean would weigh the
    ranks' positions unequally whenever their masks hold different counts.

    With a ``seq`` group of more than one rank the rows keep the whole
    sequence and the rank runs its slice of positions [r S/n, (r + 1)
    S/n), attending over the whole sequence by the ring
    (``ring_attention_fn`` over ``seq`` unless ``attention_fn`` is given).
    Each position's target is the next token of the whole sequence, so a
    slice's last position reads the next slice's first token and the
    sequence's last position has none; the count and the share are summed
    over ``seq`` as over ``data``."""
    rows = data if isinstance(data, tuple) else (data or SeqGroup(),)
    seq = seq or SeqGroup()
    n = tokens.shape[1] // seq.world
    lo = seq.rank * n
    if seq.world > 1 and attention_fn is None:
        attention_fn = partial(ring_attention_fn, group=seq)
    logits = forward_train(model, tokens[:, lo:lo + n], attention_fn=attention_fn, remat=remat,
                           q_offset=lo)
    hi = min(lo + n, tokens.shape[1] - 1)  # the positions with a next token
    targets = tokens[:, lo + 1:hi + 1].long()
    logits = logits[:, :hi - lo]
    mask = loss_mask[:, lo:hi].to(torch.float32)
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -logprobs.gather(-1, targets[..., None])[..., 0]
    count = mask.sum()
    for g in rows + (seq,):
        count = g.all_reduce_sum(count)
    loss = torch.sum(nll * mask) / count.clamp_min(1.0)
    for g in rows + (seq,):
        loss = reduce_from_group(loss, g)
    return loss


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True
    context_parallel: bool = False  # ring attention over the seq axis
    fsdp: bool = False  # shard stacked layers (+ their optimizer state)
    #                     over the mesh `fsdp` axis, ZeRO-3 style


class AdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2,
    eps=1e-8, weight_decay))``, the JAX trainer's optimizer, in optax's
    order and arithmetic:

    1. the global norm of the gradients, their squares summed in f32 (optax
       sums a bf16 leaf in bf16). A param group's ``axes`` are the mesh
       axes its leaves' spec names: their squares are summed over each of
       those axes' ``groups`` (``model``, ``fsdp``), so that every leaf
       counts once, as optax's norm over the whole unsharded tree;
    2. clipping as optax's ``select``: with ``g_norm >= grad_clip`` every
       gradient becomes ``g / g_norm * grad_clip``, else it is kept
       (``torch.nn.utils.clip_grad_norm_`` scales by ``max / (norm +
       1e-6)`` instead);
    3. the moments in the parameter's dtype, ``mu = (1 - b1) g + b1 mu``,
       ``nu = (1 - b2) g^2 + b2 nu``, divided by ``1 - b^count``; the
       update ``mu_hat / (sqrt(nu_hat) + eps)``;
    4. the decay added to the update, ``u + weight_decay * p``, on every
       leaf, norms and embedding too (``torch.optim.AdamW`` decays ``p``
       before the step);
    5. ``p + (-lr) * u``, in p's dtype.

    The moments are created with the optimizer, as optax's ``init``, and
    ``count`` is the steps taken."""

    def __init__(self, params, lr: float = 1e-5, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01, grad_clip: float = 1.0,
                 groups: dict[str, SeqGroup] | None = None) -> None:
        super().__init__(params, {"axes": ()})
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.groups = groups or {}
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"mu": torch.zeros_like(p, memory_format=torch.contiguous_format),
                                 "nu": torch.zeros_like(p, memory_format=torch.contiguous_format)}

    def global_norm(self) -> torch.Tensor:
        """The gradients' global L2 norm over the whole (unsharded) tree, an
        f32 device scalar, the same bits on every rank."""
        total = None
        for group in self.param_groups:
            part = torch.stack([p.grad.float().square().sum() for p in group["params"]]).sum()
            for ax in group["axes"]:
                part = self.groups.get(ax, SeqGroup()).all_reduce_sum(part)
            total = part if total is None else total + part
        return total.sqrt()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        g_norm = self.global_norm()
        clip = g_norm >= self.grad_clip  # optax keeps g when g_norm < max_norm
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad
                g = torch.where(clip, g / g_norm.to(g.dtype) * self.grad_clip, g)
                st = self.state[p]
                st["mu"].copy_((1 - b1) * g + b1 * st["mu"])
                st["nu"].copy_((1 - b2) * g.square() + b2 * st["nu"])
                u = (st["mu"] / bc1) / ((st["nu"] / bc2).sqrt() + self.eps)
                u = u + self.weight_decay * p
                p.copy_(p + (-self.lr) * u)
        return None


def model_leaves(model: LlamaModel) -> list[tuple[tuple[str, ...], torch.nn.Parameter]]:
    """The model's parameters by their path in the JAX tree, in its order
    (sorted keys)."""
    out = [(("embed",), model.embed), (("final_norm",), model.final_norm)]
    if model.lm_head is not None:
        out.append((("lm_head",), model.lm_head))
    out += [(("layers", name), w) for name, w in model.layers.items()]
    return sorted(out, key=lambda kv: kv[0])


def _spec(specs: dict, path: tuple) -> tuple:
    for k in path:
        specs = specs[k]
    return specs


def _whole_model(cfg: LlamaConfig, params, seed: int, dev: torch.device) -> LlamaModel:
    """The whole (unsharded) model to shard: drawn from ``seed``, or
    ``params``, a :class:`LlamaModel` or a tree in the JAX layout of
    tensors or of arrays (a JAX tree through ``np.asarray``)."""
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return LlamaModel(cfg, init_params(cfg, gen, dev))
    if isinstance(params, LlamaModel):
        params = params.tree()
    if torch.is_tensor(params["embed"]):
        moved = {k: v.to(dev) for k, v in params.items() if k != "layers"}
        moved["layers"] = {k: v.to(dev) for k, v in params["layers"].items()}
        return LlamaModel(cfg, moved)
    return params_from_numpy(params, cfg, device=dev)


class Trainer:
    """One optimizer step a call over this rank's view of ``mesh``
    (``parallel/mesh.py`` ``make_mesh``): every rank of the mesh builds it
    together and calls :meth:`step` together, on the same global batch.

    With ``params=None`` every rank draws the same whole tree from a
    ``torch.Generator`` seeded with ``seed`` (not the JAX package's
    threefry bits) and keeps its shard; ``params`` is a whole tree to
    shard. The trainer owns its parameters (``model``, a trainable
    :class:`LlamaModel` shard) and their AdamW moments; under ``fsdp``
    only the layers this rank owns, and their moments."""

    def __init__(
        self,
        model_config: LlamaConfig,
        mesh: Mesh,
        train_config: TrainConfig | None = None,
        params=None,
        seed: int = 0,
    ) -> None:
        self.cfg = model_config
        self.mesh = mesh
        self.tc = train_config or TrainConfig()
        self.step_count = 0
        if self.tc.fsdp:
            if AXES.fsdp not in mesh.shape:
                raise ValueError(
                    "TrainConfig.fsdp=True needs a mesh with an 'fsdp' axis "
                    "(make_mesh({'fsdp': N, ...}))"
                )
            if self.cfg.n_layers % mesh.shape[AXES.fsdp]:
                raise ValueError(
                    f"n_layers={self.cfg.n_layers} not divisible by the "
                    f"fsdp axis ({mesh.shape[AXES.fsdp]})"
                )
        dev = mesh_device(mesh.device)
        self.data = mesh.group(AXES.data)
        # the option's group, one rank when it is off: the mesh's axis is
        # then replicated compute, as under GSPMD
        self.fsdp = mesh.group(AXES.fsdp) if self.tc.fsdp else SeqGroup()
        self.seq = mesh.group(AXES.seq) if self.tc.context_parallel else SeqGroup()
        whole = _whole_model(self.cfg, params, seed, dev)
        shard = shard_params(whole, mesh, fsdp=self.tc.fsdp)
        del whole
        own = {k: v.detach().clone() for k, v in shard.tree().items() if k != "layers"}
        own["layers"] = {k: v.detach().clone() for k, v in shard.tree()["layers"].items()}
        self.model = LlamaModel(self.cfg, own, tp=shard.tp, trainable=True, fsdp=shard.fsdp)
        del shard, own
        groups: dict[tuple, list] = {}
        for _, p, spec in self.leaves():
            groups.setdefault(tuple(ax for ax in spec if ax), []).append(p)
        self.optimizer = AdamW(
            [{"params": ps, "axes": axes} for axes, ps in groups.items()],
            lr=self.tc.learning_rate, b1=self.tc.b1, b2=self.tc.b2,
            weight_decay=self.tc.weight_decay, grad_clip=self.tc.grad_clip,
            groups={AXES.model: self.model.tp, AXES.fsdp: self.fsdp},
        )

    def leaves(self) -> list[tuple[tuple[str, ...], torch.nn.Parameter, tuple]]:
        """(path, parameter, spec) of every leaf, in the JAX tree's order."""
        specs = param_specs(self.cfg.tie_embeddings, fsdp=self.tc.fsdp,
                            qk_norm=self.cfg.qk_norm, sandwich_norms=self.cfg.sandwich_norms)
        return [(path, p, _spec(specs, path)) for path, p in model_leaves(self.model)]

    @property
    def params(self) -> dict:
        """This rank's shard of the parameters as a JAX-layout tree (the
        trainer's own tensors, not copies)."""
        return self.model.tree()

    @property
    def opt_state(self) -> dict:
        """The AdamW state: ``count`` and the moments ``mu``, ``nu`` as trees
        shaped like :attr:`params` (the trainer's own tensors)."""
        out = {"count": self.optimizer.count, "mu": {"layers": {}}, "nu": {"layers": {}}}
        for path, p, _ in self.leaves():
            for kind in ("mu", "nu"):
                node = out[kind]["layers"] if path[0] == "layers" else out[kind]
                node[path[-1]] = self.optimizer.state[p][kind]
        return out

    def backward(self, tokens, loss_mask=None) -> torch.Tensor:
        """The step's loss and gradients on the global batch ``tokens`` [B,
        S] (int, the same on every rank): this rank takes its rows (over
        ``data``, and ``fsdp`` with ``fsdp=True``) and, with
        ``context_parallel=True``, its slice of the sequence. Leaves each
        parameter's ``grad`` as the update reads it, the whole batch's
        gradient of this rank's shard. Returns the loss, a device scalar
        with the same bits on every rank."""
        tokens = torch.as_tensor(tokens).to(torch.int32)
        B, S = tokens.shape
        batch_div = self.mesh.shape.get(AXES.data, 1)
        if self.tc.fsdp:
            batch_div *= self.mesh.shape.get(AXES.fsdp, 1)
        if B % batch_div:
            raise ValueError(
                f"batch size {B} must be divisible by "
                f"data{'×fsdp' if self.tc.fsdp else ''} mesh axes ({batch_div}); "
                "with fsdp=True the batch shards over both axes"
            )
        seq_div = self.mesh.shape.get(AXES.seq, 1) if self.tc.context_parallel else 1
        if S % seq_div:
            raise ValueError(
                f"sequence length {S} must be divisible by the seq mesh axis "
                f"({seq_div}); with context_parallel=True the sequence shards over it"
            )
        if loss_mask is None:
            loss_mask = torch.ones_like(tokens, dtype=torch.bool)
        loss_mask = torch.as_tensor(loss_mask).to(torch.bool)
        rows = (self.data, self.fsdp)
        lo, hi = batch_rows(rows, B)
        dev = self.model.device
        loss = lm_loss(self.model, tokens[lo:hi].to(dev), loss_mask[lo:hi].to(dev),
                       remat=self.tc.remat, data=rows, seq=self.seq)
        loss.backward()
        for _, p, spec in self.leaves():
            # a layer leaf's sum over fsdp is gather_layer's backward
            for g in (self.data, *(() if AXES.fsdp in spec else (self.fsdp,)), self.seq):
                g.all_reduce_sum(p.grad)
        return loss

    def step(self, tokens, loss_mask=None) -> float:
        """One optimizer step on the global batch ``tokens`` [B, S]
        (:meth:`backward`, then the update). Returns the global loss, the
        same float on every rank."""
        t0 = time.time()
        loss = self.backward(tokens, loss_mask)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        loss = float(loss.detach())
        self.step_count += 1
        logger.info("step %d: loss=%.4f (%.2fs)", self.step_count, loss, time.time() - t0)
        return loss
