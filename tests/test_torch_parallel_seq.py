"""The port's seq group across two ranks: two spawned CPU processes joined
over gloo (``file://`` rendezvous, one torch thread each) run ring
attention, the long prefill, the merged long decode attention and greedy
long-context generation, and the parent holds their results against one
rank and against the JAX package on a ``{"seq": 2}`` CPU mesh.

Each rank is joined with a 120 s limit, so a hung collective fails the
test instead of stalling the suite. The module imports no JAX at the top:
the spawned ranks import it to find their entry point.
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np
import pytest
import torch

PROMPTS = [
    "Tóm tắt văn bản sau: nền kinh tế tăng trưởng ổn định trong quý một. " * 2,
    "hai",
    "Một tài liệu dài hơn hẳn nói về chính sách giáo dục và y tế cơ sở "
    "tại các địa phương miền núi phía bắc. " * 3,
]
WORLD = 2
S = 512            # prompt bucket of the prefill checks: 256 slots a rank
PADS = [0, 70, 300]  # row 2's pad covers all of rank 0's shard
MAX_NEW = 16
JOIN_S = 120


def _rank_main(rank: int, init_file: str, out_dir: str, payload: dict) -> None:
    """One rank: join the group, run every check on its share, save."""
    torch.set_num_threads(1)
    from vnsum_tpu_torch.backend import long_context as tlc
    from vnsum_tpu_torch.models.llama import LlamaModel
    from vnsum_tpu_torch.parallel import SeqGroup, ring_attention

    group = SeqGroup.init(rank, WORLD, f"file://{init_file}", device="cpu", timeout_s=60)
    try:
        model = LlamaModel(payload["cfg"], payload["tree"])
        G = model.cfg.q_per_kv
        pads = torch.tensor(PADS, dtype=torch.int32)
        lo, hi = rank * S // WORLD, (rank + 1) * S // WORLD
        out = {}
        q, k, v = payload["ring"]
        out["ring"] = ring_attention(
            q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], G, group, pads
        )
        out["prefill"] = tlc.long_prefill(model, payload["tokens"], pads, group)
        cache, qd, dec, t = payload["decode"]
        shard = {n: c[:, :, :, lo:hi].contiguous() for n, c in cache.items()}
        out["decode"] = tlc.make_long_decode_attention(shard, pads, G, group)(qd, dec, 1, t)
        for quantize_kv in (False, True):
            out[f"generate_int8={quantize_kv}"] = tlc.TorchLongContextBackend(
                model=model, group=group, batch_size=4, max_new_tokens=MAX_NEW,
                max_total_tokens=2048, quantize_kv=quantize_kv, device="cpu",
            ).generate(PROMPTS)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        group.close()


def test_two_gloo_ranks_match_one_rank_and_jax(tmp_path):
    import jax.numpy as jnp

    from vnsum_tpu.backend import long_context as jlc
    from vnsum_tpu.parallel.mesh import make_mesh
    from vnsum_tpu.parallel.ring import ring_attention as jax_ring
    from vnsum_tpu_torch.backend import long_context as tlc
    from vnsum_tpu_torch.parallel import SeqGroup, ring_attention

    from test_torch_models_llama import carried_weights

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jcfg, params, model = carried_weights(4, max_seq_len=2048)
        G, H, KV, hd = jcfg.q_per_kv, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
        rng = np.random.default_rng(0)
        ring_in = [rng.standard_normal((3, S, n, hd)).astype(np.float32) for n in (H, KV, KV)]
        tokens = rng.integers(0, 256, size=(3, S)).astype(np.int32)
        for b, p in enumerate(PADS):
            tokens[b, :p] = 258
        pads = torch.tensor(PADS, dtype=torch.int32)
        tokens_t = torch.from_numpy(tokens)
        one = SeqGroup()
        logits1, cache1 = tlc.long_prefill(model, tokens_t, pads, one)
        qd = torch.from_numpy(rng.standard_normal((3, 1, H, hd)).astype(np.float32))
        dec = {n: torch.from_numpy(rng.standard_normal(c.shape[:3] + (8, hd)).astype(np.float32))
               for n, c in cache1.items()}
        for c in dec.values():
            c[:, :, :, 4:] = 0.0
        t = 3
        tree = {
            "embed": model.embed.data, "final_norm": model.final_norm.data,
            "layers": {n: p.data for n, p in model.layers.items()},
        }
        payload = {
            "cfg": model.cfg, "tree": tree,
            "ring": [torch.from_numpy(a) for a in ring_in],
            "tokens": tokens_t, "decode": (cache1, qd, dec, t),
        }

        ctx = multiprocessing.get_context("spawn")
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, str(tmp_path / "rendezvous"), str(tmp_path), payload))
            for r in range(WORLD)
        ]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(JOIN_S)
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            assert not hung, f"seq ranks {hung} did not finish within {JOIN_S} s"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        assert [p.exitcode for p in procs] == [0] * WORLD
        ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]

        # ring attention: the two ranks' query blocks against one rank and JAX
        ring_t = [torch.from_numpy(a) for a in ring_in]
        want1 = ring_attention(*ring_t, G, one, pads)
        got = torch.cat([r["ring"] for r in ranks], dim=1)
        torch.testing.assert_close(got, want1, rtol=1e-5, atol=1e-5)
        mesh = make_mesh({"seq": WORLD}, platform="cpu")
        want_jax = jax_ring(*(jnp.asarray(a) for a in ring_in), G, mesh=mesh,
                            pad_lens=jnp.asarray(PADS, dtype=jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-5, atol=1e-5)

        # the ring prefill: the last position's logits on both ranks, each
        # rank's shard of the cache
        for r, res in enumerate(ranks):
            logits, cache = res["prefill"]
            torch.testing.assert_close(logits, logits1, rtol=2e-4, atol=2e-4)
            for n in ("k", "v"):
                torch.testing.assert_close(
                    cache[n], cache1[n][:, :, :, r * S // WORLD:(r + 1) * S // WORLD],
                    rtol=2e-4, atol=2e-4,
                )

        # the merged decode attention (K2p's plain version on each rank's
        # shard): against one rank, and against JAX on seq=2 with its kernel
        # in interpret mode and with its dense partial
        want = tlc.make_long_decode_attention(cache1, pads, G, one)(qd, dec, 1, t)
        for res in ranks:
            torch.testing.assert_close(res["decode"], want, rtol=2e-5, atol=2e-5)
        jcache = {n: jnp.asarray(c.numpy()) for n, c in cache1.items()}
        for kernel in (True, False):
            want_jax = jlc.make_long_decode_attention(
                mesh, jcache, jnp.asarray(PADS, dtype=jnp.int32), G,
                decode_kernel=kernel, interpret=kernel,
            )(jnp.asarray(qd.numpy()), {n: jnp.asarray(c.numpy()) for n, c in dec.items()},
              jnp.int32(1), t)
            np.testing.assert_allclose(
                ranks[0]["decode"].numpy(), np.asarray(want_jax), rtol=2e-5, atol=2e-5)

        # greedy generation: byte-identical to one rank and to JAX on seq=2
        for quantize_kv in (False, True):
            texts = [res[f"generate_int8={quantize_kv}"] for res in ranks]
            assert texts[0] == texts[1]
            world1 = tlc.TorchLongContextBackend(
                model=model, batch_size=4, max_new_tokens=MAX_NEW, max_total_tokens=2048,
                quantize_kv=quantize_kv, device="cpu",
            ).generate(PROMPTS)
            jax_texts = jlc.LongContextBackend(
                model_config=jcfg, mesh=mesh, params=params, batch_size=4,
                max_new_tokens=MAX_NEW, max_total_tokens=2048, quantize_kv=quantize_kv,
            ).generate(PROMPTS)
            assert texts[0] == world1 == jax_texts, quantize_kv
            assert any(texts[0])
    finally:
        torch.set_num_threads(threads)


def test_seq_group_rules():
    from vnsum_tpu_torch.parallel import SeqGroup

    one = SeqGroup()
    x = torch.arange(4.0)
    # one rank: every collective is the identity, no process group needed
    assert one.all_reduce_max(x) is x and one.all_reduce_sum(x) is x
    assert one.ring_shift(x) is x and one.broadcast(x, 0) is x
    assert SeqGroup.init(0, 1, "file:///nonexistent") == one
    with pytest.raises(ValueError, match="process group"):
        SeqGroup(0, 2)
    with pytest.raises(ValueError, match="outside"):
        SeqGroup(2, 2, object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs card"):
            SeqGroup.init(0, 2, "file:///nonexistent", device="cuda")
