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
- the update is optax's ``clip_by_global_norm`` then ``adamw``, in optax's
  order (:class:`AdamW`), on parameters and moments the trainer owns;
- each block is recomputed in the backward pass (``remat``).

``TrainConfig(fsdp=True)`` (ZeRO-3 over an ``fsdp`` axis) and
``TrainConfig(context_parallel=True)`` (ring attention over ``seq``) are
ROADMAP A12b and raise by name.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..core.logging import get_logger
from ..models.llama import LlamaConfig, LlamaModel, forward_train, init_params, params_from_numpy
from ..parallel.autograd import reduce_from_group
from ..parallel.mesh import AXES, Mesh, mesh_device
from ..parallel.seq import SeqGroup
from ..parallel.sharding import data_rows, param_specs, shard_params

logger = get_logger("vnsum.train")


def lm_loss(
    model: LlamaModel,
    tokens: torch.Tensor,      # [B, S]
    loss_mask: torch.Tensor,   # [B, S] bool — positions whose NEXT token counts
    *,
    attention_fn=None,
    remat: bool = True,
    data: SeqGroup | None = None,
) -> torch.Tensor:
    """Next-token cross-entropy, mean over the unmasked positions of the
    whole batch.

    With a ``data`` group of more than one rank, ``tokens`` and
    ``loss_mask`` are this rank's rows of the batch: the count of unmasked
    positions is summed over the group, and so is the rank's share of the
    loss (*g*: the sum forward, the identity backward). Every rank then
    returns the global mean, and its gradient is its own rows' part of the
    global mean's gradient, which the trainer sums over ``data``. Averaging
    each rank's own mean would weigh the ranks' positions unequally
    whenever their masks hold different counts."""
    data = data or SeqGroup()
    logits = forward_train(model, tokens, attention_fn=attention_fn, remat=remat)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    mask = loss_mask[:, :-1].to(torch.float32)
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -logprobs.gather(-1, targets[..., None])[..., 0]
    count = data.all_reduce_sum(mask.sum())
    return reduce_from_group(torch.sum(nll * mask) / count.clamp_min(1.0), data)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True
    context_parallel: bool = False  # ring attention over the seq axis (A12b)
    fsdp: bool = False  # shard stacked layers (+ their optimizer state)
    #                     over the mesh `fsdp` axis, ZeRO-3 style (A12b)


class AdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2,
    eps=1e-8, weight_decay))``, the JAX trainer's optimizer, in optax's
    order and arithmetic:

    1. the global norm of the gradients, their squares summed in f32 (optax
       sums a bf16 leaf in bf16). Under a ``model`` group of more than one
       rank, the squares of the leaves in param groups marked ``sharded``
       are summed over the group and the replicated leaves counted once;
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
                 model_group: SeqGroup | None = None) -> None:
        super().__init__(params, {"sharded": False})
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.model_group = model_group or SeqGroup()
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"mu": torch.zeros_like(p, memory_format=torch.contiguous_format),
                                 "nu": torch.zeros_like(p, memory_format=torch.contiguous_format)}

    def global_norm(self) -> torch.Tensor:
        """The gradients' global L2 norm over the whole (unsharded) tree, an
        f32 device scalar."""
        parts = {True: [], False: []}
        for group in self.param_groups:
            parts[group["sharded"]] += [p.grad.float().square().sum() for p in group["params"]]
        dev = self.param_groups[0]["params"][0].device
        sharded = torch.stack(parts[True]).sum() if parts[True] else torch.zeros((), device=dev)
        replicated = torch.stack(parts[False]).sum() if parts[False] else torch.zeros((), device=dev)
        return (self.model_group.all_reduce_sum(sharded) + replicated).sqrt()

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
    :class:`LlamaModel` shard) and their AdamW moments."""

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
            raise NotImplementedError(
                "TrainConfig.fsdp=True: stacked layers sharded over the 'fsdp' axis "
                "(ZeRO-3) are ROADMAP A12b, not ported yet")
        if self.tc.context_parallel:
            raise NotImplementedError(
                "TrainConfig.context_parallel=True: ring attention over the 'seq' axis "
                "is ROADMAP A12b, not ported yet")
        dev = mesh_device(mesh.device)
        self.data = mesh.group(AXES.data)
        whole = _whole_model(self.cfg, params, seed, dev)
        shard = shard_params(whole, mesh)
        del whole
        own = {k: v.detach().clone() for k, v in shard.tree().items() if k != "layers"}
        own["layers"] = {k: v.detach().clone() for k, v in shard.tree()["layers"].items()}
        self.model = LlamaModel(self.cfg, own, tp=shard.tp, trainable=True)
        del shard, own
        groups = {True: [], False: []}
        for _, p, spec in self.leaves():
            groups[AXES.model in spec].append(p)
        self.optimizer = AdamW(
            [{"params": ps, "sharded": sharded} for sharded, ps in groups.items() if ps],
            lr=self.tc.learning_rate, b1=self.tc.b1, b2=self.tc.b2,
            weight_decay=self.tc.weight_decay, grad_clip=self.tc.grad_clip,
            model_group=self.model.tp,
        )

    def leaves(self) -> list[tuple[tuple[str, ...], torch.nn.Parameter, tuple]]:
        """(path, parameter, spec) of every leaf, in the JAX tree's order."""
        specs = param_specs(self.cfg.tie_embeddings, qk_norm=self.cfg.qk_norm,
                            sandwich_norms=self.cfg.sandwich_norms)
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

    def step(self, tokens, loss_mask=None) -> float:
        """One optimizer step on the global batch ``tokens`` [B, S] (int,
        the same on every rank; this rank takes its ``data`` rows). Returns
        the global loss, the same float on every rank."""
        tokens = torch.as_tensor(tokens).to(torch.int32)
        batch_div = self.mesh.shape.get(AXES.data, 1)
        if tokens.shape[0] % batch_div:
            raise ValueError(
                f"batch size {tokens.shape[0]} must be divisible by "
                f"data mesh axes ({batch_div}); "
                "with fsdp=True the batch shards over both axes"
            )
        if loss_mask is None:
            loss_mask = torch.ones_like(tokens, dtype=torch.bool)
        loss_mask = torch.as_tensor(loss_mask).to(torch.bool)
        lo, hi = data_rows(self.data, tokens.shape[0])
        dev = self.model.device
        t0 = time.time()
        loss = lm_loss(self.model, tokens[lo:hi].to(dev), loss_mask[lo:hi].to(dev),
                       remat=self.tc.remat, data=self.data)
        loss.backward()
        for p in self.model.parameters():
            self.data.all_reduce_sum(p.grad)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        loss = float(loss.detach())
        self.step_count += 1
        logger.info("step %d: loss=%.4f (%.2fs)", self.step_count, loss, time.time() - t0)
        return loss
