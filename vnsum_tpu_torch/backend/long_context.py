"""Long-context generation: ring prefill + seq-sharded decode.

Counterpart of ``vnsum_tpu/backend/long_context.py``. The one-card engine
(``backend/engine.py``) cuts every prompt at the model's ``max_seq_len``;
this backend runs whole documents past it. A :class:`SeqGroup` of N ranks
(one card each, or CPU processes over gloo) splits the sequence:

- **Prefill** runs the full prompt as ONE forward. Each rank holds S/N
  positions and writes their K/V into its own stacked prefill cache
  ``[L, B, KV, S/N, hd]``, the layout the decode kernels read. With one
  rank the attention is the prefill kernel K1 over that cache (the same
  function the ring computes at one rank); with more it is
  :func:`ring_attention`, whose K/V blocks rotate around the group.
- **Decode** keeps the prefill cache frozen and split. Every step, every
  rank runs the decode-partials kernel K2p over its whole shard and the
  group merges the unnormalised (o, m, l) states with max and sum
  all-reduce (the log-sum-exp algebra); the result merges again with the
  attention over the small decode cache of freshly generated tokens, which
  every rank holds whole. New tokens' K/V go only into that decode cache,
  so nothing is resharded in the loop.

The decode step reuses the decoder's ``stacked_attention_fn`` seam, so the
cache write, RoPE and MLP are the one-card engine's code. The JAX program
runs the decode as an on-device ``while_loop``; here a host loop runs one
step function (:func:`long_decode_step`) over persistent device buffers and
reads the all-done flag every ``DONE_CHECK_INTERVAL`` steps, which never
changes an output. At one rank on the card, for greedy generation, the loop
replays the step as a captured CUDA graph (``backend/capture.py``); above
one rank it stays eager, since the all-reduces are not captured. Every rank
computes the same tokens.

``quantize=True`` runs int8 weights (``models/quant.py``), as the JAX
backend does: the long decode's projections and LM head (B rows) go through
the int8-weight GEMV kernel, the prefill's through a dequantized
``torch.matmul``.

Under a mesh (``mesh=``, ``parallel/mesh.py``) the backend runs on the
``data``, ``model`` and ``seq`` axes, one process a card, every rank calling
``generate`` with the same prompts (SPMD), as the JAX backend's
``P(data, seq)`` and ``P(data, model, seq)`` shardings place it:

- ``seq``: the split above, over the mesh's seq group;
- ``model``: the weights are this rank's shard (``shard_params``), the
  forward runs the tensor-parallel collectives, and the ring, K2p and the
  decode-cache partial run on the local heads (H/model and KV/model);
- ``data``: a batch starts at ``data`` rows and ``batch_size`` rounds to a
  multiple of it, as in JAX; each data rank runs its own rows, and the
  generated ids are gathered over ``data`` so that every rank returns the
  same texts. A sampled row draws from ``row_seed(seed, u, step)`` with
  ``u`` its row in the whole batch, so a row's stream does not depend on
  the ``data`` size.
"""
from __future__ import annotations

import math
import time

import torch

from ..core.config import GenerationConfig
from ..core.logging import get_logger
from ..models.llama import (
    LlamaConfig,
    LlamaModel,
    init_kv_cache,
    init_model,
    llama32_3b,
    params_from_numpy,
    prefill_positions,
    quantize_kv,
)
from ..models.quant import quantize_model
from ..models.sampling import row_seed, sample_logits_rows
from ..ops.decode_attention import flash_decode_partials
from ..ops.flash_attention import NEG, flash_prefill_attention
from ..parallel import SeqGroup, ring_attention
from ..parallel.mesh import AXES
from ..parallel.sharding import data_rows, gather_rows, shard_params
from ..text.tokenizer import Tokenizer, get_tokenizer
from .base import (
    fold_seed,
    left_pad_batch,
    mask_unsampleable,
    resolve_max_new,
    sampling_vocab,
    terminator_ids,
    trim_to_eos,
)
from .capture import captures, decode_buffers, decode_loop, token_step
from .engine import EngineStats, resolve_device

logger = get_logger("vnsum.long")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- prefill -----------------------------------------------------------------


def long_prefill(
    model: LlamaModel,
    tokens: torch.Tensor,     # [B, S] left-padded, the whole prompt on every rank
    pad_lens: torch.Tensor,   # [B] int32
    group: SeqGroup | None = None,
):
    """One forward over the full prompt, each rank on its S/N positions.

    Returns (last_logits [B, V] f32, the same on every rank; this rank's
    prefill cache {"k","v": [L, B, KV, S/N, hd]} in the model dtype, KV
    the model shard's local KV heads)."""
    group = group or SeqGroup()
    cfg = model.cfg
    B, S = tokens.shape
    n, r = group.world, group.rank
    if S % n:
        raise ValueError(f"prompt length {S} does not split over {n} seq ranks")
    S_loc = S // n
    lo = r * S_loc
    G = cfg.q_per_kv
    positions = prefill_positions(pad_lens, S)[:, lo : lo + S_loc]
    cache = init_kv_cache(cfg, B, S_loc, device=model.device,
                          kv_heads=cfg.n_kv_heads // model.tp.world)
    if n == 1:
        # the ring at one rank: causal attention over the whole cache, K1
        # (its plain version for CPU tensors; on the card it raises for a
        # head dim it does not take)
        def stacked(q, c, li):
            return flash_prefill_attention(q, c, li, pad_lens, G, 0, 0)
    else:
        def stacked(q, c, li):
            return ring_attention(
                q, c["k"][li].transpose(1, 2), c["v"][li].transpose(1, 2), G, group, pad_lens
            )
    logits = model(
        tokens[:, lo : lo + S_loc], positions, cache, 0, None, last_only=True,
        stacked_attention_fn=stacked,
    )
    # the prompt's last position lives on the last rank
    last = group.broadcast(logits[:, 0].contiguous(), src=n - 1)
    return last, cache


def quantize_prefill_cache(cache: dict) -> dict:
    """[L, B, KV, S, hd] cache -> int8 values + per-(layer, row, head,
    token) f32 scales (``models.llama.quantize_kv``). Decode streams every
    shard each step, so this halves its cache traffic. Quantized a layer at
    a time: the f32 temporaries stay one layer's size."""
    k = cache["k"]
    out = {
        "k": torch.empty(k.shape, dtype=torch.int8, device=k.device),
        "v": torch.empty(k.shape, dtype=torch.int8, device=k.device),
        "ks": torch.empty(k.shape[:-1], dtype=torch.float32, device=k.device),
        "vs": torch.empty(k.shape[:-1], dtype=torch.float32, device=k.device),
    }
    for li in range(k.shape[0]):
        out["k"][li], out["ks"][li] = quantize_kv(cache["k"][li])
        out["v"][li], out["vs"][li] = quantize_kv(cache["v"][li])
    return out


# -- decode over the split prefill cache ---------------------------------------


def _merge_across(group: SeqGroup, o, m, l):
    """LSE-merge per-rank (o, m, l) states over the group (pmax, psum)."""
    m_g = group.all_reduce_max(m.clone())
    corr = torch.exp(m - m_g)
    l_g = group.all_reduce_sum(l * corr)
    o_g = group.all_reduce_sum(o * corr[..., None])
    return o_g, m_g, l_g


def _kernel_partial_local(q, prefill_cache, pads_local, layer_idx, *, q_per_kv, group):
    """K2p over this rank's whole stacked shard (the layer chosen by index,
    int8 dequantized in the kernel), merged across the group. q [B, 1, H,
    hd]; ``pads_local`` the left pads in shard coordinates (a row whose pad
    covers the shard comes out inert). CPU tensors take K2p's plain version;
    on the card K2p raises for inputs it does not take."""
    S_loc = prefill_cache["k"].shape[3]
    o, m, l = flash_decode_partials(
        q, prefill_cache, layer_idx, pads_local, S_loc - 1, q_per_kv
    )
    return _merge_across(group, o, m, l)


def make_long_decode_attention(
    prefill_cache: dict,
    pad_lens: torch.Tensor,
    q_per_kv: int,
    group: SeqGroup | None = None,
):
    """The merged attention for the decoder's ``stacked_attention_fn``
    seam: ``attention(q, cache, layer_idx, t)`` attends this group's split
    prefill cache (through K2p) and the small decode cache ``cache``, valid
    slots 0..t."""
    group = group or SeqGroup()
    S_loc = prefill_cache["k"].shape[3]
    # left pads in this shard's coordinates: a row whose pad lies past the
    # shard masks it out entirely
    pads_local = (
        (pad_lens.long() - group.rank * S_loc).clamp(0, S_loc).to(torch.int32).contiguous()
    )

    def attention(q, cache, layer_idx, t):
        """q [B, 1, H, hd]; cache the decode cache [L, B, KV, C, hd]; ``t``
        an int or a one-element tensor on the device (the captured step's)."""
        B, _, H, hd = q.shape
        o1, m1, l1 = _kernel_partial_local(
            q, prefill_cache, pads_local, layer_idx, q_per_kv=q_per_kv, group=group
        )

        # decode-cache partial (every rank holds the whole decode cache)
        k_dec, v_dec = cache["k"][layer_idx], cache["v"][layer_idx]   # [B, KV, C, hd]
        KV, C = k_dec.shape[1], k_dec.shape[2]
        qg = q[:, 0].reshape(B, KV, q_per_kv, hd).float()
        scores = torch.einsum("bkgh,bkch->bkgc", qg, k_dec.float()) / math.sqrt(hd)
        valid = (torch.arange(C, device=q.device) <= t)[None, None, None, :]
        scores = scores.masked_fill(~valid, NEG)
        m2 = scores.amax(dim=-1)
        p = torch.exp(scores - m2[..., None]).masked_fill(~valid, 0.0)
        l2 = p.sum(dim=-1).reshape(B, H)
        o2 = torch.einsum("bkgc,bkch->bkgh", p, v_dec.float()).reshape(B, H, hd)
        m2 = m2.reshape(B, H)

        # log-sum-exp merge of the two partials
        m = torch.maximum(m1, m2)
        c1 = torch.exp(m1 - m)
        c2 = torch.exp(m2 - m)
        l = l1 * c1 + l2 * c2
        o = o1 * c1[..., None] + o2 * c2[..., None]
        out = o / l.clamp_min(1e-30)[..., None]
        return out[:, None].to(q.dtype)  # [B, 1, H, hd]

    return attention


# -- full generation program -------------------------------------------------


def long_decode_step(model: LlamaModel, attention, buffers: dict, cache: dict, pads,
                     S: int, eos, pad_id: int, sample):
    """The long path's one-token decode step over its
    ``capture.decode_buffers``, as ``step(t_host)``
    (``capture.token_step``): the decode cache ``cache`` is written and
    attended at the device ``t``, so the step also runs as a captured graph.
    ``attention`` is :func:`make_long_decode_attention`'s; ``sample(logits
    [B, V], step)`` draws the next tokens."""

    def forward(cur, t):
        return model(
            cur[:, None], ((S - pads.long()) + t)[:, None], cache, t.expand(cur.shape[0]),
            None, stacked_attention_fn=lambda q, c, li: attention(q, c, li, t),
        )

    return token_step(
        buffers, eos, pad_id, forward, lambda logits, step: sample(logits[:, -1], step)
    )


def generate_long_tokens(
    model: LlamaModel,
    tokens: torch.Tensor,     # [B, S] left-padded, S % group.world == 0
    pad_lens: torch.Tensor,   # [B] int32
    max_new: int,
    *,
    eos_ids,
    pad_id: int,
    group: SeqGroup | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    quantize_kv: bool = False,
    vocab_limit: int = 0,
    vocab_allowed=None,
    stats: EngineStats | None = None,
    cuda_graphs: bool = False,
    row_offset: int = 0,
) -> torch.Tensor:
    """Prefill, then the decode loop; returns the emitted ids [B, max_new].

    Row ``b``'s sampled token at step ``t`` draws from ``row_seed(seed,
    row_offset + b, t)`` (step 0 is the prefill's token): ``row_offset`` is
    this data rank's first row in the whole batch. ``quantize_kv`` stores the frozen
    prefill cache int8. ``cuda_graphs`` replays the greedy decode step as a
    captured CUDA graph (one rank on the card). ``stats`` collects the
    prefill and decode seconds (each ended by a synchronize), forwards,
    steps and captured steps."""
    group = group or SeqGroup()
    cfg = model.cfg
    dev = model.device
    B, S = tokens.shape
    eos = torch.tensor(list(eos_ids), dtype=torch.long, device=dev)
    V = vocab_limit or cfg.vocab_size
    allowed = None if vocab_allowed is None else torch.as_tensor(vocab_allowed, device=dev)

    def sample(rows, step):  # rows [B, vocab] f32
        seeds = ([row_seed(seed, row_offset + u, step) for u in range(B)]
                 if temperature > 0 else [])
        return sample_logits_rows(
            mask_unsampleable(rows[:, :V], allowed), seeds, temperature, top_k, top_p
        )

    t_pre = time.time()
    last_logits, prefill_cache = long_prefill(model, tokens, pad_lens, group)
    if quantize_kv:
        prefill_cache = quantize_prefill_cache(prefill_cache)
    cur = sample(last_logits, 0)
    done = pad_lens == S  # all-pad filler rows start done
    _sync(dev)
    if stats is not None:
        stats.prefill_forwards += 1
        stats.add_phase("prefill", time.time() - t_pre)

    t_dec = time.time()
    if cuda_graphs and (temperature > 0 or group.world > 1):
        # sampled rows read host-seeded generators; the all-reduces of more
        # ranks are not captured
        raise ValueError("a captured long decode needs greedy rows and one seq rank")
    attention = make_long_decode_attention(prefill_cache, pad_lens, cfg.q_per_kv, group)
    buffers = decode_buffers(cur, done, max_new, pad_id)
    decode_cache = init_kv_cache(cfg, B, max_new, device=dev,
                                 kv_heads=cfg.n_kv_heads // model.tp.world)
    step = long_decode_step(
        model, attention, buffers, decode_cache, pad_lens, S, eos, pad_id, sample,
    )
    run = decode_loop(step, done, max_new, capture=cuda_graphs)
    _sync(dev)
    if stats is not None:
        stats.decode_steps += run.steps
        stats.graph_captures += run.captures
        stats.captured_steps += run.replays
        stats.add_phase("decode", time.time() - t_dec)
    return buffers["out"]


class TorchLongContextBackend:
    """Backend-protocol generation over a seq group: prompts up to (ranks
    x the one-card limit) tokens run untruncated. Paired with the truncated
    strategy (``max_context`` set to the long limit) it summarizes whole
    VN-LongSum documents in one shot.

    The ranks come from ``mesh`` (its ``seq`` group, and its ``data`` and
    ``model`` axes) or, without one, from ``group``, a seq group alone;
    passing both raises. Every rank calls ``generate`` with the same
    prompts and gets the same texts. ``references`` and ``cache_hints``
    are accepted and unused, as in the JAX backend."""

    name = "torch"

    def __init__(
        self,
        model_config: LlamaConfig | None = None,
        group: SeqGroup | None = None,
        tokenizer: str | Tokenizer = "byte",
        model: LlamaModel | None = None,
        params: dict | None = None,
        batch_size: int = 1,
        max_new_tokens: int = 1024,
        max_total_tokens: int | None = None,
        generation: GenerationConfig | None = None,
        seed: int = 0,
        quantize: bool = False,
        quantize_kv: bool = False,
        cuda_graphs: str | bool = "auto",
        mesh=None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = model.cfg if model is not None else (model_config or llama32_3b())
        if self.cfg.sliding_window:
            raise NotImplementedError(
                "TorchLongContextBackend runs ring attention (global K/V "
                "streaming); sliding-window configs are one-card-engine only"
            )
        if mesh is not None and group is not None:
            raise ValueError("pass mesh= or group=, not both: the mesh holds the seq group")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"this rank's mesh device is {mesh.device}, the backend's "
                             f"{self.device}")
        # this rank's view of the mesh (parallel/mesh.py), or None
        self.mesh = mesh
        self.group = mesh.group(AXES.seq) if mesh is not None else (group or SeqGroup())
        self._data = mesh.group(AXES.data) if mesh is not None else SeqGroup()
        model_size = mesh.shape.get(AXES.model, 1) if mesh is not None else 1
        # captured greedy decode steps: on by default at one seq rank on the
        # card, where the mesh's model collectives can be captured (NCCL's;
        # the seq all-reduces of more ranks are not captured); True raises
        # where they cannot apply
        can_capture = (self.device.type == "cuda" and self.group.world == 1
                       and (mesh is None or mesh.captures_collectives()))
        if cuda_graphs is True and not can_capture:
            raise ValueError("cuda_graphs=True needs a CUDA device, one seq rank and, under a "
                             "mesh, model collectives a graph can capture (NCCL's)")
        self._graphs_required = cuda_graphs is True
        self.cuda_graphs = can_capture if cuda_graphs == "auto" else bool(cuda_graphs)
        self.tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
        # prompts here are near the memory ceiling by definition: one row
        # at a time unless the caller's memory budget allows more. Rounded
        # down to a multiple of the data axis (the value is the caller's
        # memory high-water mark), but at least one row a data rank
        data_size = self._data.world
        self.batch_size = max(data_size, (max(int(batch_size), 1) // data_size) * data_size)
        if data_size > 1 and self.batch_size != batch_size:
            logger.warning(
                "batch_size adjusted %d -> %d (mesh data axis %d needs a "
                "divisible row count); per-dispatch memory scales with it",
                batch_size, self.batch_size, data_size,
            )
        self.max_new_tokens = max_new_tokens
        # the long path ignores cfg.max_seq_len (the one-card ceiling)
        self.max_total_tokens = max_total_tokens or self.cfg.max_seq_len * self.group.world
        if max_new_tokens >= self.max_total_tokens:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} must be < "
                f"max_total_tokens={self.max_total_tokens}"
            )
        self.gen_cfg = generation or GenerationConfig()
        self._seed = seed
        self._dispatch = 0
        self.quantize_kv = bool(quantize_kv)
        self.stats = EngineStats()
        if model is None:
            model = (
                params_from_numpy(params, self.cfg, self.device) if params is not None
                else init_model(self.cfg, seed, self.device)
            )
        elif model.device != self.device:
            raise ValueError(f"model lives on {model.device}, backend on {self.device}")
        if quantize and not model.quantized:
            model = quantize_model(model)
        if mesh is not None:
            if model.tp.world == 1:
                model = shard_params(model, mesh)
            elif model.tp.world != model_size:
                raise ValueError(
                    f"the model is a shard over {model.tp.world} ranks, the mesh's "
                    f"model axis has {model_size}"
                )
        elif model.tp.world != 1:
            raise ValueError("a model shard needs the mesh it was sharded over (mesh=)")
        self.model = model

    def _gather_rows(self, local: torch.Tensor, B: int) -> torch.Tensor:
        """The [B, ...] batch of every data rank's rows (gathered over
        ``data``, as the engine gathers them)."""
        return gather_rows(self._data, local, B)

    def _bucket(self, n: int) -> int:
        """Round S up to a multiple of (ranks x 128), doubling, capped at
        the total budget."""
        step = self.group.world * 128
        b = step
        while b < n:
            b *= 2
        return min(b, ((self.max_total_tokens + step - 1) // step) * step)

    def _next_seed(self, gen: GenerationConfig) -> int:
        s = fold_seed(gen.seed, self._seed, self._dispatch)
        self._dispatch += 1
        return s

    @torch.inference_mode()
    def generate(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int | None = None,
        config: GenerationConfig | None = None,
        references: list[str | None] | None = None,  # spec metadata; unused
        cache_hints: list[str | None] | None = None,  # cache metadata; unused
    ) -> list[str]:
        gen = config or self.gen_cfg
        max_new = resolve_max_new(max_new_tokens, gen, self.max_new_tokens)
        if max_new >= self.max_total_tokens:
            raise ValueError(
                f"max_new_tokens={max_new} must be < "
                f"max_total_tokens={self.max_total_tokens}"
            )
        if not prompts:
            return []
        self.stats.calls += 1
        self.stats.prompts += len(prompts)
        encoded = []
        for ids in self.tok.encode_batch(prompts, add_bos=True):
            ids = ids[: self.max_total_tokens - max_new]
            encoded.append(ids)
            self.stats.prompt_tokens += len(ids)
        eos_ids = terminator_ids(self.tok, gen)
        vocab_limit, vocab_allowed = sampling_vocab(self.tok, self.cfg.vocab_size, eos_ids)

        # length-sorted groups of at most batch_size rows, each bucketed for
        # its longest member: one longest-prompt batch would exceed memory
        # and make every short prompt pay the longest prefill
        order = sorted(range(len(encoded)), key=lambda i: len(encoded[i]))
        results: list[str | None] = [None] * len(encoded)
        t0 = time.time()
        for start in range(0, len(order), self.batch_size):
            group = order[start : start + self.batch_size]
            S = self._bucket(max(len(encoded[i]) for i in group))
            # at least one row a data rank; batch_size is the caller's memory
            # high-water mark, never exceeded to reach a power of two (it is
            # a multiple of the data axis, so the clamp stays divisible)
            B = self._data.world
            while B < len(group):
                B *= 2
            B = min(B, self.batch_size)
            tokens, pad_lens = left_pad_batch(
                [encoded[i] for i in group], B, S, self.tok.pad_id
            )
            lo, hi = data_rows(self._data, B)
            t_group = time.time()
            local = generate_long_tokens(
                self.model, torch.from_numpy(tokens[lo:hi]).to(self.device),
                torch.from_numpy(pad_lens[lo:hi]).to(self.device), max_new,
                eos_ids=eos_ids, pad_id=self.tok.pad_id, group=self.group,
                temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
                seed=self._next_seed(gen), quantize_kv=self.quantize_kv,
                vocab_limit=vocab_limit, vocab_allowed=vocab_allowed, stats=self.stats,
                cuda_graphs=captures(gen, self.cuda_graphs, self._graphs_required),
                row_offset=lo,
            )
            out = self._gather_rows(local, B).cpu().numpy()
            logger.info(
                "long generate: B=%d S=%d new=%d in %.1fs", B, S, max_new, time.time() - t_group
            )
            self.stats.batches += 1
            self.stats.by_bucket[(B, S)] = self.stats.by_bucket.get((B, S), 0) + 1
            for row, i in enumerate(group):
                self.stats.generated_tokens += int((out[row] != self.tok.pad_id).sum())
                ids = trim_to_eos(
                    out[row].tolist(), self.tok.eos_id, self.tok.pad_id, tuple(gen.eos_ids)
                )
                results[i] = self.tok.decode(ids).strip()
        self.stats.generate_seconds += time.time() - t0
        return results  # type: ignore[return-value]

    def count_tokens(self, text: str) -> int:
        return self.tok.count(text)

    def count_tokens_batch(self, texts: list[str]) -> list[int]:
        return self.tok.count_batch(texts)
