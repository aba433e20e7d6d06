#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (vnsum_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so any failure exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmul and cuDNN;
2. build: every kernel of ``vnsum_tpu_torch/ops/csrc`` compiled with nvcc
   for sm_90a, timed;
3. correctness: each kernel against its plain PyTorch version on the card,
   at the stated limits (TOLERANCES below), over bf16 and int8 caches,
   query offsets, windows, left pads with a row that sees no key, a layer
   other than 0, a fill short of the cache; at the pipeline's own batches
   (map B=8 S=4096 C=4224, decode fills 4096 and 4223; reduce B=8 S=512
   C=640); the verify kernel at the spec path's shape (B=8, Sq=9,
   C=4096+128+9, ragged fills on both sides of a split boundary, a row
   parked at the budget, a row whose pad hides every key from its first
   queries, a window) and at the slot segment's (B=8, Sq=1, C=4224, a
   fill per row, a free row and a row parked at limit C); and the last
   layer of a long-bucket cache, whose offsets pass 2^31;
4. planted faults: each kernel rebuilt, in a temporary copy of the package,
   with one cache slot per split or tile left out, must fail every case of
   that kernel in phase 3, so the limits are shown to be tight enough to
   see such a fault;
5. timing at the main path's shapes (Llama-3.2-3B: L=28, H=24, KV=8,
   hd=128; prefill B=8 S=4096 C=4224, decode B=8 C=4224 fill=4200; verify
   B=8 Sq=9 C=4233 and B=8 Sq=1 C=4224): the kernel, the bound (bytes over
   3.35 TB/s or FLOP over the peak rate of their type, from this run's
   inputs), the plain version, and one PyTorch library call computing the
   same function (scaled_dot_product_attention with an explicit mask on a
   bf16 cache; timed here only, never used by the port); one output of
   each is held against the other as in phase 3; and the prefill kernel
   alone at the pipeline's default long bucket (S=15360, C=16384);
6. pipeline: the port's CLI runs map-reduce over data/vi_eval with
   Llama-3.2-3B at full width and depth (random bf16 weights from a seed):
   every document must succeed, every summary be written, ROUGE be
   computed, and the kernel launch counters move by at least one launch per
   layer per prefill forward and per decode step;
7. spec pipeline (path a): the same run through PipelineRunner with a
   backend built with GenerationConfig(spec_k=8), so every map and reduce
   group decodes speculatively against its references through the verify
   kernel: 7/7 documents, ROUGE, verify launches = 28 x verify steps; then
   the map batch again with the plain run's outputs as references, which
   must accept drafts (multi-token steps, ragged per-row fills on the card);
8. slot loop (path b): TorchBackend.start_slot_loop(slots=8,
   prompt_tokens=4096, max_new_tokens=128, segment_tokens=32) fed the 7 map
   prompts in two waves and drained, at fused_segments 1 and 4: every
   request completes and verify launches = 28 x the decode steps run;
9. profile: one prefill forward and one decode step at the map batch's
   shape, with their wall time, the device's busy time (torch.profiler),
   the card's clock and power draw while they run, and the kernels that
   take most of the time.

Each path phase sets every launch counter to 0 just before it and reads
them just after; a kernel of the path that was not launched fails it. The
line before the last is a JSON object with one entry per kernel, whose
``launches`` sums the path phases; the last line is the device record.
Without a card the script exits non-zero and prints neither.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# TOLERANCES: the stated limits on |kernel - plain|, from each kernel's
# sound error.
# decode and verify: both versions are f32 throughout and differ by
#   summation order (~1e-6 relative) and then by at most one bf16 ulp in the
#   final cast, where ulp(x) <= 2^-7 |x|: per element, 1e-4 + 2^-7 |plain|.
# prefill: besides, both round p to bf16 before PV, the kernel against its
#   running max and the plain version against the row max: two roundings of
#   up to 2^-9, which move an output by a few 2^-9 of its row's scale, on
#   top of the final cast's 2^-7: per (query, head) row, 2e-2 times the
#   largest |plain| of its hd elements, so a row that sees no key must be 0.
DECODE_ATOL, DECODE_RTOL = 1e-4, 2.0**-7
PREFILL_ROW_RTOL = 2e-2

# phase 4's planted faults: (what it does, kernel, source, text, replacement)
MUTANTS = (
    ("decode leaves out the last slot of every 512-slot split", "decode", "flash_decode.cu",
     "split * SPLIT + SPLIT - 1", "split * SPLIT + SPLIT - 2"),
    ("prefill leaves out the last slot of every unmasked 64-slot tile", "prefill",
     "flash_prefill.cu",
     "      l_run[i] += p;\n",
     "      if (!MASKED && nt == BN / 8 - 1 && tig == 3 && (e & 1)) p = 0.f;\n"
     "      l_run[i] += p;\n"),
    ("verify leaves out the last slot of every 512-slot split", "verify", "flash_verify.cu",
     "split * SPLIT + SPLIT - 1", "split * SPLIT + SPLIT - 2"),
)

KERNELS = {
    "prefill": {
        "name": "flash_prefill_attention",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_prefill.cu",
        "replaces": "vnsum_tpu/ops/flash_attention.py:313",
    },
    "decode": {
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:381",
    },
    "verify": {
        "name": "flash_spec_verify_attention",
        "route": "cuda",
        "source": "vnsum_tpu_torch/ops/csrc/flash_verify.cu",
        "replaces": "vnsum_tpu/ops/decode_attention.py:510",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ------------------------------------------------------------------


def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return smi


# -- phase 2 ------------------------------------------------------------------


def phase_build() -> float:
    """Builds every kernel and prints each kernel function's registers and
    spills (ptxas -v) and K3's dynamic shared memory at the main path's
    row counts."""
    from vnsum_tpu_torch.ops import kernels
    from vnsum_tpu_torch.ops import verify_attention as va

    t0 = time.perf_counter()
    logs = kernels.build_all()
    seconds = time.perf_counter() - t0
    for name, out in logs.items():
        function = "?"
        for line in out.splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[-1].strip()
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {function}: {line.strip()}")
    log(f"[build] {len(logs)} kernel libraries built in {seconds:.2f}s")
    lib = va._library()
    for R in (3, 27):
        log(f"[build] flash_verify dynamic shared memory at Sq*G={R}: "
            f"int8 {lib.vnsum_flash_verify_smem(R, 1)} B, bf16 {lib.vnsum_flash_verify_smem(R, 0)} B")
    return seconds


# -- inputs -------------------------------------------------------------------


def make_cache(torch, L, B, KV, C, hd, quantized, seed, dev):
    from vnsum_tpu_torch.models.llama import quantize_kv

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    k = torch.randn((L, B, KV, C, hd), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((L, B, KV, C, hd), generator=g, device=dev, dtype=torch.bfloat16)
    if not quantized:
        return {"k": k, "v": v}
    cache = {
        "k": torch.empty(k.shape, dtype=torch.int8, device=dev),
        "v": torch.empty(k.shape, dtype=torch.int8, device=dev),
        "ks": torch.empty(k.shape[:-1], dtype=torch.float32, device=dev),
        "vs": torch.empty(k.shape[:-1], dtype=torch.float32, device=dev),
    }
    for li in range(L):  # a layer at a time keeps the f32 temporaries small
        cache["k"][li], cache["ks"][li] = quantize_kv(k[li])
        cache["v"][li], cache["vs"][li] = quantize_kv(v[li])
    return cache


def rand_q(torch, shape, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)


FAILED: list[str] = []  # the cases over their limit


def compare(torch, name, case, got, want, worst) -> None:
    """Holds a kernel's output against its plain version's at the stated
    limit and logs the case: its largest |err| (kept in ``worst[name]``)
    and its largest err/limit. A case over its limit goes into FAILED."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if name == "prefill":
        limit = PREFILL_ROW_RTOL * want.abs().amax(dim=-1, keepdim=True)
    else:
        limit = DECODE_ATOL + DECODE_RTOL * want.abs()
    err = float(diff.max())
    used = float((diff / limit.clamp_min(1e-30)).max())
    bad = not bool(torch.isfinite(got).all()) or bool((diff > limit).any())
    worst[name] = max(worst[name], err)
    if bad:
        FAILED.append(case)
    log(f"[check] {case}: max|err| {err:.3e}, err/limit {used:.4g}"
        + (" OVER THE LIMIT" if bad else ""))


def raise_if_failed() -> None:
    if FAILED:
        raise AssertionError(
            f"kernels disagree with their plain versions in {len(FAILED)} cases: "
            + "; ".join(FAILED))


# -- phase 3 ------------------------------------------------------------------


def phase_correctness(torch) -> dict:
    """Every case of phase 3; returns the largest |err| of each kernel and
    raises, after the last case, if any case was over its limit."""
    from vnsum_tpu_torch.models.llama import quantize_kv
    from vnsum_tpu_torch.ops import decode_attention as da
    from vnsum_tpu_torch.ops import flash_attention as fa
    from vnsum_tpu_torch.ops import verify_attention as va

    dev = torch.device("cuda")
    KV, G, hd = 8, 3, 128
    H = KV * G
    worst = {"prefill": 0.0, "decode": 0.0, "verify": 0.0}

    def pads_of(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def verify(case, q, cache, layer, pads_h, fills_h, window=0, blind=()):
        """K3 against its plain version; ``blind`` lists (row, queries)
        that see no key and must come out 0."""
        pads, fills = pads_of(pads_h), pads_of(fills_h)
        got = va.flash_spec_verify_attention(q, cache, layer, pads, fills, G, window)
        want = va.flash_spec_verify_attention_ref(q, cache, layer, pads, fills, G, window)
        compare(torch, "verify", f"verify {case}", got, want, worst)
        for row, queries in blind:
            if float(got[row, queries].float().abs().max()) != 0.0:
                FAILED.append(f"verify {case}: row {row} queries {queries} see no key "
                              "and must come out 0")

    def prefill(case, q, cache, layer, pads, window, q_offset, empty_row=None):
        got = fa.flash_prefill_attention(q, cache, layer, pads, G, window, q_offset)
        want = fa.flash_prefill_attention_ref(q, cache, layer, pads, G, window, q_offset)
        compare(torch, "prefill", f"prefill {case}", got, want, worst)
        if empty_row is not None and float(got[empty_row].float().abs().max()) != 0.0:
            FAILED.append(f"prefill {case}: row {empty_row} sees no key and must come out 0")

    def decode(case, q, cache, layer, pads, fill, window, empty_row=None):
        got = da.flash_decode_attention(q, cache, layer, pads, fill, G, window)
        want = da.flash_decode_attention_ref(q, cache, layer, pads, fill, G, window)
        compare(torch, "decode", f"decode {case}", got, want, worst)
        if empty_row is not None and float(got[empty_row].float().abs().max()) != 0.0:
            FAILED.append(f"decode {case}: row {empty_row} sees no key and must come out 0")

    L, B, S, C = 3, 3, 2048, 2176
    for quantized in (False, True):
        cache = make_cache(torch, L, B, KV, C, hd, quantized, 1 + quantized, dev)
        for q_offset, window, layer in ((0, 0, 1), (128, 0, 2), (0, 1024, 1), (128, 1024, 2)):
            q = rand_q(torch, (B, S, H, hd), 7 + q_offset + window, dev)
            # row 2 sees no key: its pad covers every query slot
            prefill(f"int8={quantized} B={B} S={S} C={C} q_offset={q_offset} "
                    f"window={window} layer={layer}", q, cache, layer,
                    pads_of([0, 37, q_offset + S]), window, q_offset, empty_row=2)
        for fill, window, layer in ((2000, 0, 1), (2175, 0, 2), (2000, 1024, 2)):
            q = rand_q(torch, (B, 1, H, hd), 11 + fill + window, dev)
            # row 2 sees no key (pad beyond the fill)
            decode(f"int8={quantized} B={B} C={C} fill={fill} window={window} layer={layer}",
                   q, cache, layer, pads_of([0, 37, C - 1 if fill < C - 1 else 0]), fill,
                   window, empty_row=2 if fill < C - 1 else None)
        del cache

    # the pipeline's own batches (128 new tokens, so C = S + 128): the map
    # batch, 7 documents and an all-pad filler row at bucket 4096, and the
    # reduce batch at bucket 512; decode at the first and the last step
    for S, pads_h in ((4096, [0, 37, 400, 1000, 2500, 3000, 4095, 4096]),
                      (512, [0, 5, 60, 128, 200, 300, 511, 512])):
        B, C, layer = len(pads_h), S + 128, 1
        pads = pads_of(pads_h)
        for quantized in (True, False):
            cache = make_cache(torch, 2, B, KV, C, hd, quantized, 30 + S + quantized, dev)
            q = rand_q(torch, (B, S, H, hd), 31 + S, dev)
            prefill(f"int8={quantized} B={B} S={S} C={C} layer={layer} (pipeline batch)",
                    q, cache, layer, pads, 0, 0, empty_row=B - 1)
            for fill in (S, C - 1):
                qd = rand_q(torch, (B, 1, H, hd), 32 + fill, dev)
                decode(f"int8={quantized} B={B} C={C} fill={fill} layer={layer} "
                       "(pipeline batch)", qd, cache, layer, pads, fill, 0)
            del cache, q, qd
    torch.cuda.empty_cache()

    # K3 at the spec path's shape: B=8, spec_k 8 (Sq=9), S=4096, 128 new
    # tokens, C = 4096 + 128 + 9. Fills S + e: rows 0-3 put their last query
    # on both sides of the split boundary at 4096 and 4608, row 4 is parked
    # at e = max_new, row 5's pad hides every key from its queries 0-2, row
    # 7 is the all-pad filler row; layer 2 of 3
    S, Sq, C = 4096, 9, 4096 + 128 + 9
    v_fills = [4088, 4090, 4600, 4599, 4096 + 128, 4150, 4096, 4111]
    v_pads = [0, 37, 400, 1000, 2500, 4153, 4095, 4096]
    for quantized in (False, True):
        cache = make_cache(torch, 3, 8, KV, C, hd, quantized, 40 + quantized, dev)
        for window, layer in ((0, 2), (1024, 1)):
            q = rand_q(torch, (8, Sq, H, hd), 41 + window, dev)
            verify(f"int8={quantized} B=8 Sq={Sq} C={C} window={window} layer={layer} "
                   "(spec path)", q, cache, layer, v_pads, v_fills, window,
                   blind=((5, slice(0, 3)),))
        del cache, q
    # K3 at the slot segment's shape: Sq=1, C = 4096 + 128, fills S + t_b
    # all different, row 6 a free slot (pad = S), row 7 parked at limit C
    C = 4096 + 128
    s_fills = [4096, 4101, 4113, 4160, 4196, 4223, 4096 + 3, 4096 + 128]
    s_pads = [0, 37, 400, 1000, 2500, 3000, 4096, 64]
    for quantized in (False, True):
        cache = make_cache(torch, 2, 8, KV, C, hd, quantized, 50 + quantized, dev)
        verify(f"int8={quantized} B=8 Sq=1 C={C} layer=1 (slot segment)",
               rand_q(torch, (8, 1, H, hd), 51, dev), cache, 1, s_pads, s_fills)
        del cache
    torch.cuda.empty_cache()

    # the pipeline's default bucket (S=15360, C=16384, B=8, L=28): the last
    # layer of the int8 cache starts past 2^31 elements, so a 32-bit offset
    # anywhere in a kernel reads the wrong layer
    L, B, C, layer = 28, 8, 16384, 27
    shape = (L, B, KV, C, hd)
    cache = {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
    }
    for name in ("k", "v"):
        vals = rand_q(torch, shape[1:], 21 + len(name), dev)
        cache[name][layer], cache[name[0] + "s"][layer] = quantize_kv(vals)
        del vals
    if cache["k"][layer].storage_offset() <= 2**31:
        raise AssertionError("the last layer must start past 2^31 elements")
    pads = pads_of([64 * i for i in range(B)])
    prefill(f"int8=True B={B} S=256 q_offset={C - 256} layer={layer} of a {L}-layer "
            f"C={C} cache (offsets past 2^31)", rand_q(torch, (B, 256, H, hd), 23, dev),
            cache, layer, pads, 0, C - 256)
    decode(f"int8=True B={B} fill={C - 1} layer={layer} of a {L}-layer C={C} cache "
           "(offsets past 2^31)", rand_q(torch, (B, 1, H, hd), 24, dev), cache, layer,
           pads, C - 1, 0)
    verify(f"int8=True B={B} Sq=9 layer={layer} of a {L}-layer C={C} cache "
           "(offsets past 2^31)", rand_q(torch, (B, 9, H, hd), 25, dev), cache, layer,
           [64 * i for i in range(B)], [C - 9 - 100 * i for i in range(B)])
    del cache
    torch.cuda.empty_cache()
    raise_if_failed()
    return worst


# -- phase 4 ------------------------------------------------------------------


def phase_mutants() -> None:
    """Each planted fault of MUTANTS, built into a temporary copy of the
    package, must fail every case of its kernel in phase 3 there and leave
    the other kernels' cases passing: the limits see a kernel that leaves
    out one cache slot in 512 (decode, verify) or one in 64 away from the
    causal diagonal (prefill). The copies build and run in parallel."""
    with tempfile.TemporaryDirectory() as root:
        procs = []
        for i, (what, kernel, source, text, replacement) in enumerate(MUTANTS):
            tmp = Path(root) / str(i)
            shutil.copytree(ROOT / "vnsum_tpu_torch", tmp / "vnsum_tpu_torch",
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            cu = tmp / "vnsum_tpu_torch" / "ops" / "csrc" / source
            code = cu.read_text()
            if code.count(text) != 1:
                raise AssertionError(f"planted fault '{what}': its text is not once in {source}")
            cu.write_text(code.replace(text, replacement))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import torch, chip_smoke as c; "
                 "c.phase_environment(torch); c.phase_build(); c.phase_correctness(torch)"],
                cwd=tmp, env={**os.environ, "PYTHONPATH": str(tmp)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        results = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    for (what, kernel, *_), (out, err, rc) in zip(MUTANTS, results):
        checks = [ln[len("[check] "):] for ln in out.splitlines() if ln.startswith("[check] ")]
        for line in checks:
            log(f"[mutant] {what}: {line}")
        mine = [ln for ln in checks if ln.startswith(kernel + " ")]
        caught = [ln for ln in mine if ln.endswith("OVER THE LIMIT")]
        others = [ln for ln in checks if not ln.startswith(kernel + " ")
                  and ln.endswith("OVER THE LIMIT")]
        if rc == 0 or not mine or len(caught) != len(mine) or others:
            raise AssertionError(
                f"planted fault '{what}' was not caught in every {kernel} case and only "
                f"there (exit {rc}, {len(caught)} of {len(mine)} caught, {len(others)} "
                f"other cases over):\n" + (out + err)[-4000:])
        log(f"[mutant] {what}: over the limit in all {len(mine)} {kernel} cases and in "
            f"none of the other {len(checks) - len(mine)}, as it must be")


# -- phase 5 ------------------------------------------------------------------


def time_ms(torch, fn, n: int, reps: int = 5) -> float:
    """Median over ``reps`` runs of the mean per-call time of ``n`` calls
    (CUDA events), after one warm-up run."""
    fn(0)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def phase_timing(torch, worst) -> dict:
    """Times each kernel, its plain version and the library call at the main
    path's shapes, and holds one output of each kernel against its plain
    version's as phase 3 does (the largest |err| goes into ``worst``)."""
    from vnsum_tpu_torch.ops import decode_attention as da
    from vnsum_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    F = torch.nn.functional
    L, B, KV, G, hd = 28, 8, 8, 3, 128
    H = KV * G
    S, C, fill = 4096, 4096 + 128, 4200
    cache = make_cache(torch, L, B, KV, C, hd, True, 3, dev)
    pads_h = [64 * i for i in range(B)]
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    q = rand_q(torch, (B, S, H, hd), 5, dev)
    qd = rand_q(torch, (B, 1, H, hd), 6, dev)
    lib_layers = 4
    k_lib, v_lib = library_kv(torch, cache, lib_layers, G)
    kpos = torch.arange(C, device=dev)
    qpos = torch.arange(S, device=dev)
    pre_mask = ((kpos[None, None, :] >= pads.long()[:, None, None])
                & (kpos[None, None, :] <= qpos[None, :, None]))[:, None]
    dec_mask = ((kpos >= pads.long()[:, None]) & (kpos <= fill))[:, None, None, :]
    qt = q.transpose(1, 2)
    qdt = qd.transpose(1, 2)

    out = {}
    # prefill: causal pairs this input needs, per row (S - pad)(S - pad + 1)/2
    pairs = sum((S - p) * (S - p + 1) // 2 for p in pads_h)
    flops = 4 * hd * H * pairs
    visible = sum(S - p for p in pads_h)  # cache slots the prefill reads per head
    bytes_ = (2 * q.numel() * 2                     # q in, out
              + 2 * visible * KV * hd * 1          # int8 K and V of the layer
              + 2 * visible * KV * 4)              # their f32 scales
    ms = time_ms(torch, lambda i: fa.flash_prefill_attention(
        q, cache, i % L, pads, G, 0, 0), n=2 * L)
    plain = time_ms(torch, lambda i: fa.flash_prefill_attention_ref(
        q, cache, i % L, pads, G, 0, 0), n=1, reps=3)
    library = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, k_lib[i % lib_layers], v_lib[i % lib_layers], attn_mask=pre_mask), n=2 * lib_layers)
    out["prefill"] = timing_record(ms, plain, library, flops, bytes_, PEAK_BF16_FLOPS)
    compare(torch, "prefill", f"prefill int8=True B={B} S={S} C={C} layer={L - 1} (timing inputs)",
            fa.flash_prefill_attention(q, cache, L - 1, pads, G, 0, 0),
            fa.flash_prefill_attention_ref(q, cache, L - 1, pads, G, 0, 0), worst)
    # decode: one query per row over slots pad_b..fill
    visible = sum(fill + 1 - p for p in pads_h)
    flops = 4 * hd * H * visible
    bytes_ = 2 * qd.numel() * 2 + 2 * visible * KV * hd * 1 + 2 * visible * KV * 4
    ms = time_ms(torch, lambda i: da.flash_decode_attention(
        qd, cache, i % L, pads, fill, G, 0), n=4 * L)
    plain = time_ms(torch, lambda i: da.flash_decode_attention_ref(
        qd, cache, i % L, pads, fill, G, 0), n=L)
    library = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qdt, k_lib[i % lib_layers], v_lib[i % lib_layers], attn_mask=dec_mask), n=4 * lib_layers)
    out["decode"] = timing_record(ms, plain, library, flops, bytes_, PEAK_FP32_FLOPS)
    compare(torch, "decode", f"decode int8=True B={B} C={C} fill={fill} layer={L - 1} "
            "(timing inputs)", da.flash_decode_attention(qd, cache, L - 1, pads, fill, G, 0),
            da.flash_decode_attention_ref(qd, cache, L - 1, pads, fill, G, 0), worst)

    # verify at the slot segment's shape on the same cache (Sq=1, C=4224,
    # fills S + t_b), then at the spec path's (Sq=9, C=4233, fills S + e_b)
    out["verify_slot"] = time_verify(
        torch, worst, cache, k_lib, v_lib, pads_h, [S + 16 * i for i in range(B)], 1, 31)
    del cache, k_lib, v_lib, q
    torch.cuda.empty_cache()
    C = S + 128 + 9
    cache = make_cache(torch, L, B, KV, C, hd, True, 4, dev)
    k_lib, v_lib = library_kv(torch, cache, lib_layers, G)
    out["verify"] = time_verify(
        torch, worst, cache, k_lib, v_lib, pads_h, [S + 60 + 3 * i for i in range(B)], 9, 32)
    raise_if_failed()
    for name, rec in out.items():
        log(f"[time] {name}: kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms")
    del cache, k_lib, v_lib
    torch.cuda.empty_cache()

    # K1 alone at the pipeline's default long bucket (chunk_size 12000:
    # S=15360, C=16384), where long documents put their prefill; the plain
    # version and the library call do not fit at this size
    S, C = 15360, 16384
    cache = {
        "k": torch.zeros((L, B, KV, C, hd), dtype=torch.int8, device=dev),
        "v": torch.zeros((L, B, KV, C, hd), dtype=torch.int8, device=dev),
        "ks": torch.ones((L, B, KV, C), dtype=torch.float32, device=dev),
        "vs": torch.ones((L, B, KV, C), dtype=torch.float32, device=dev),
    }
    q = rand_q(torch, (B, S, H, hd), 8, dev)
    pads = torch.zeros(B, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda i: fa.flash_prefill_attention(
        q, cache, i % L, pads, G, 0, 0), n=4, reps=3)
    flops = 4 * hd * H * B * S * (S + 1) // 2
    bytes_ = 2 * q.numel() * 2 + 2 * B * S * KV * (hd + 4)
    rec = timing_record(ms, None, None, flops, bytes_, PEAK_BF16_FLOPS)
    log(f"[time] prefill at B={B} S={S} C={C}: kernel {ms:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s of causal work")
    del cache, q
    torch.cuda.empty_cache()
    return out


def library_kv(torch, cache, layers: int, G: int):
    """bf16 K/V of the first ``layers`` layers of an int8 cache, expanded to
    the query heads, for the library call."""
    k = [(cache["k"][li].float() * cache["ks"][li][..., None]).to(torch.bfloat16)
         .repeat_interleave(G, dim=1) for li in range(layers)]
    v = [(cache["v"][li].float() * cache["vs"][li][..., None]).to(torch.bfloat16)
         .repeat_interleave(G, dim=1) for li in range(layers)]
    return k, v


def time_verify(torch, worst, cache, k_lib, v_lib, pads_h, fills_h, Sq, seed) -> dict:
    """K3, its plain version and the library call on one int8 cache at Sq
    queries per row and per-row fills; one output of the kernel is held
    against the plain version's as in phase 3. The bound counts what these
    inputs need: each row's visible K/V slots and scales read once, q read
    and the output written once, and 4 hd FLOP (f32) per visible (query
    head, slot) pair."""
    from vnsum_tpu_torch.ops import verify_attention as va

    dev = cache["k"].device
    L, B, KV, C, hd = cache["k"].shape
    G = k_lib[0].shape[1] // KV
    H = KV * G
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    fills = torch.tensor(fills_h, dtype=torch.int32, device=dev)
    q = rand_q(torch, (B, Sq, H, hd), seed, dev)
    limit = fills.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    kpos = torch.arange(C, device=dev)
    mask = ((kpos[None, None, :] >= pads.long()[:, None, None])
            & (kpos[None, None, :] <= limit[:, :, None]))[:, None]
    qt = q.transpose(1, 2)
    pairs = sum(max(min(f + s, C - 1) - p + 1, 0)
                for p, f in zip(pads_h, fills_h) for s in range(Sq))
    rows = sum(max(min(f + Sq - 1, C - 1) - p + 1, 0) for p, f in zip(pads_h, fills_h))
    flops = 4 * hd * H * pairs
    bytes_ = 2 * q.numel() * 2 + 2 * rows * KV * (hd + 4)
    ms = time_ms(torch, lambda i: va.flash_spec_verify_attention(
        q, cache, i % L, pads, fills, G, 0), n=4 * L)
    plain = time_ms(torch, lambda i: va.flash_spec_verify_attention_ref(
        q, cache, i % L, pads, fills, G, 0), n=4)
    library = time_ms(torch, lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, k_lib[i % len(k_lib)], v_lib[i % len(k_lib)], attn_mask=mask), n=4 * len(k_lib))
    compare(torch, "verify", f"verify int8=True B={B} Sq={Sq} C={C} layer={L - 1} "
            "(timing inputs)", va.flash_spec_verify_attention(q, cache, L - 1, pads, fills, G, 0),
            va.flash_spec_verify_attention_ref(q, cache, L - 1, pads, fills, G, 0), worst)
    return timing_record(ms, plain, library, flops, bytes_, PEAK_FP32_FLOPS)


def timing_record(ms, plain, library, flops, bytes_, peak_flops) -> dict:
    t_ops = flops / peak_flops * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return {
        "ms": ms, "plain_ms": plain, "library_ms": library,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


# -- phase 6 ------------------------------------------------------------------


def agreement(texts: list, base: list) -> str:
    """How many texts equal their base text, and the characters each shares
    with it before the first difference (a near-tie flip shows as a long
    shared prefix, a fault as a short one)."""
    shared = [len(os.path.commonprefix([a, b])) for a, b in zip(texts, base)]
    same = sum(a == b for a, b in zip(texts, base))
    return f"{same}/{len(base)} equal, shared prefix chars {shared} of {[len(b) for b in base]}"


def reset_launches() -> None:
    from vnsum_tpu_torch.ops import decode_attention, flash_attention, verify_attention

    flash_attention.launches = decode_attention.launches = verify_attention.launches = 0


def read_launches() -> dict:
    from vnsum_tpu_torch.ops import decode_attention, flash_attention, verify_attention

    return {"prefill": flash_attention.launches, "decode": decode_attention.launches,
            "verify": verify_attention.launches}


def check_launches(path: str, launches: dict, need: dict) -> None:
    """Each kernel of ``need`` must have launched at least as often as the
    path needs, and at least once."""
    for name, n in need.items():
        if launches[name] < n or launches[name] == 0:
            raise AssertionError(
                f"{path}: {name} kernel launched {launches[name]} times, needs >= {n}")
    log(f"[launches] {path}: " + ", ".join(f"{k} {v}" for k, v in launches.items()))


def check_run(res: dict, docs, gen_dir: Path) -> tuple[dict, dict]:
    """A pipeline run's record: every document ok, every summary written,
    ROUGE computed. Returns (record, {doc name: summary})."""
    rec = res["summarization"]["llama3.2:3b"]
    if rec["successful"] != len(docs) or rec["failed"] != 0:
        raise AssertionError(f"documents: {rec['successful']} ok, {rec['failed']} failed")
    out_dir = Path(f"{gen_dir}_mapreduce_llama3_2_3b")
    written = sorted(p.name for p in out_dir.glob("*.txt"))
    if written != [d.name for d in docs]:
        raise AssertionError(f"summaries written: {written}")
    rouge = res["evaluation"]["llama3.2:3b"]["rouge_scores"]
    if not all(math.isfinite(v) for v in rouge.values()):
        raise AssertionError(f"ROUGE not computed: {rouge}")
    return rec, {p.name: p.read_text(encoding="utf-8") for p in out_dir.glob("*.txt")}


def phase_pipeline(torch) -> tuple[dict, dict]:
    """The plain map-reduce run through the CLI; returns (launches,
    summaries)."""
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.pipeline import cli

    n_layers = llama32_3b().n_layers
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    with tempfile.TemporaryDirectory() as tmp:
        gen_dir = Path(tmp) / "gen"
        args = [
            "--approach", "mapreduce", "--models", "llama3.2:3b",
            "--docs-dir", str(ROOT / "data/vi_eval/doc"),
            "--summary-dir", str(ROOT / "data/vi_eval/summary"),
            "--generated-summaries-dir", str(gen_dir),
            "--results-dir", str(Path(tmp) / "results"),
            "--logs-dir", str(Path(tmp) / "logs"),
            "--max-new-tokens", "128", "--device", "cuda",
        ]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(args)
        wall = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f"pipeline CLI exited {rc}")
        res = json.loads(next((Path(tmp) / "results").glob("pipeline_results_*.json")).read_text())
        rec, summaries = check_run(res["results"], docs, gen_dir)
        rouge = res["results"]["evaluation"]["llama3.2:3b"]["rouge_scores"]
        eng = res["results"]["engine"]["llama3.2:3b"]
        check_launches("pipeline", launches, {
            "prefill": n_layers * eng["prefill_forwards"],
            "decode": n_layers * eng["decode_steps"]})
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[pipeline] {rec['successful']}/{len(docs)} docs ok, {rec['failed']} failed, "
        f"chunks {rec['total_chunks']}, wall {wall:.2f}s, "
        f"prefill {eng['phase_seconds'].get('prefill', 0.0):.3f}s "
        f"({eng['prefill_forwards']} forwards), "
        f"decode {eng['phase_seconds'].get('decode', 0.0):.3f}s "
        f"({eng['decode_steps']} steps), generated tokens {eng['generated_tokens']}, "
        f"batches {eng['by_bucket']}, peak memory {peak_gb:.2f} GB")
    log(f"[pipeline] rouge {json.dumps(rouge)}")
    return launches, summaries


# -- phase 7 ------------------------------------------------------------------


def phase_spec_pipeline(torch, plain_summaries: dict):
    """Path (a): map-reduce through PipelineRunner with a spec_k=8 backend,
    then the oracle run. Returns (launches, backend, map prompts, the map
    batch's one-shot outputs)."""
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.core.config import GenerationConfig, PipelineConfig
    from vnsum_tpu_torch.models import llama32_3b
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner
    from vnsum_tpu_torch.strategies import get_strategy

    n_layers = llama32_3b().n_layers
    docs = sorted((ROOT / "data/vi_eval/doc").glob("*.txt"))
    backends = []

    def factory(_):
        backends.append(TorchBackend(
            llama32_3b(), generation=GenerationConfig(spec_k=8), max_new_tokens=128,
            batch_size=8, seed=0, device="cuda"))
        return backends[-1]

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig(
            approach="mapreduce", models=["llama3.2:3b"], max_new_tokens=128,
            docs_dir=str(ROOT / "data/vi_eval/doc"),
            summary_dir=str(ROOT / "data/vi_eval/summary"),
            generated_summaries_dir=str(Path(tmp) / "gen"),
            results_dir=str(Path(tmp) / "results"), logs_dir=str(Path(tmp) / "logs"),
        )
        reset_launches()
        t0 = time.perf_counter()
        runner = PipelineRunner(cfg, backend_factory=factory, device="cuda")
        res = runner.run()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if runner.failures:
            raise AssertionError(f"spec pipeline failures: {runner.failures}")
        rec, summaries = check_run(
            {"summarization": res.summarization, "evaluation": res.evaluation},
            docs, Path(tmp) / "gen")
    backend = backends[0]
    st = backend.stats
    if st.spec_verify_steps == 0:
        raise AssertionError("the spec pipeline ran no verify step")
    check_launches("spec pipeline", launches, {
        "prefill": n_layers * st.prefill_forwards, "verify": n_layers * st.spec_verify_steps})
    names = sorted(summaries)
    same = agreement([summaries[n] for n in names], [plain_summaries[n] for n in names])
    log(f"[spec] pipeline {rec['successful']}/{len(docs)} docs ok, wall {wall:.2f}s, prefill "
        f"{st.phase_seconds.get('prefill', 0.0):.3f}s ({st.prefill_forwards} forwards), spec "
        f"decode {st.phase_seconds.get('spec_decode', 0.0):.3f}s ({st.spec_verify_steps} "
        f"verify steps), drafted {st.spec_draft_tokens}, accepted {st.spec_accepted_tokens}, "
        f"generated tokens {st.generated_tokens}; against the plain run's summaries: {same} "
        "(not gated: random bf16 weights give near-ties)")
    log(f"[spec] rouge {json.dumps(res.evaluation['llama3.2:3b']['rouge_scores'])}")

    # the oracle: the map batch again, with its one-shot outputs as the
    # references, must accept drafts
    strategy = get_strategy("mapreduce", backend, cfg)
    prompts = [strategy.map_prompt.format(content=c)
               for d in docs for c in strategy.splitter.split_text(d.read_text(encoding="utf-8"))]
    reset_launches()
    oneshot = backend.generate(prompts)
    steps0, acc0 = st.spec_verify_steps, st.spec_accepted_tokens
    t0 = time.perf_counter()
    oracle = backend.generate(prompts, references=oneshot)
    wall = time.perf_counter() - t0
    oracle_launches = read_launches()
    report = backend.take_spec_report()
    steps, accepted = st.spec_verify_steps - steps0, st.spec_accepted_tokens - acc0
    if accepted <= 0:
        raise AssertionError(f"the oracle run accepted no draft: {report}")
    check_launches("oracle", oracle_launches, {
        "prefill": 2 * n_layers, "decode": n_layers, "verify": n_layers * steps})
    log(f"[spec] oracle: {len(prompts)} map prompts, {steps} verify steps, drafted "
        f"{sum(r.draft_tokens for r in report)}, accepted {accepted}, per-row accepted "
        f"{[r.accepted_tokens for r in report]}, spec wall {wall:.2f}s; against the "
        f"one-shot outputs: {agreement(oracle, oneshot)}")
    # control: the same one-shot generate at another batch shape, which
    # changes no math but the GEMM tiling; its agreement with the batch-8
    # run is what bf16 near-ties alone give
    control = TorchBackend(model=backend.model, batch_size=4, max_new_tokens=128,
                           device="cuda").generate(prompts)
    log(f"[spec] control: one-shot at batch 4 against batch 8: "
        f"{agreement(control, oneshot)}")
    total = {k: launches[k] + oracle_launches[k] for k in launches}
    return total, backend, prompts, oneshot


# -- phase 8 ------------------------------------------------------------------


def phase_slot_loop(torch, backend, prompts: list, oneshot: list) -> dict:
    """Path (b): the in-flight slot loop over the map prompts, fed in two
    waves and drained, at fused_segments 1 and 4. Returns the launches."""
    from vnsum_tpu_torch.backend.engine import TorchBackend

    n_layers = backend.cfg.n_layers
    b = TorchBackend(model=backend.model, batch_size=8, max_new_tokens=128,
                     segment_tokens=32, device="cuda")
    total = {"prefill": 0, "decode": 0, "verify": 0}
    texts = {}
    for fused in (1, 4):
        reset_launches()
        forwards0 = b.stats.prefill_forwards
        t0 = time.perf_counter()
        loop = b.start_slot_loop(slots=8, prompt_tokens=4096, max_new_tokens=128,
                                 fused_segments=fused)
        outs: dict = {}
        adm, rej = loop.admit([(i, prompts[i], None) for i in range(3)])
        if rej or len(adm) != 3:
            raise AssertionError(f"first wave: {len(adm)} admitted, {rej} rejected")
        pending = list(range(3, len(prompts)))
        for _ in range(64):
            for c in loop.step().completions:
                outs[c.key] = c.text
            if pending and loop.free:
                adm, rej = loop.admit([(i, prompts[i], None) for i in pending])
                if rej:
                    raise AssertionError(f"rejected {rej}")
                for a in adm:
                    pending.remove(a.key)
            if not pending and loop.active == 0:
                break
        wall = time.perf_counter() - t0
        launches = read_launches()
        if sorted(outs) != list(range(len(prompts))):
            raise AssertionError(f"slot loop completed {sorted(outs)} of {len(prompts)}")
        if launches["verify"] != n_layers * loop.decode_steps:
            raise AssertionError(
                f"verify launched {launches['verify']} times for {loop.decode_steps} steps")
        check_launches(f"slot loop fused={fused}", launches, {
            "prefill": n_layers * (b.stats.prefill_forwards - forwards0),
            "verify": n_layers * loop.decode_steps})
        texts[fused] = [outs[i] for i in range(len(prompts))]
        log(f"[slot] fused={fused}: {len(prompts)}/{len(prompts)} requests done, "
            f"{loop.refills} admitted, {loop.fused_dispatches} dispatches, {loop.segments} "
            f"segments, {loop.decode_steps} decode steps, wall {wall:.2f}s; against the "
            f"one-shot outputs: {agreement(texts[fused], oneshot)} (not gated)")
        loop.close()
        for k in total:
            total[k] += launches[k]
    log(f"[slot] fused=4 texts equal fused=1's: {texts[4] == texts[1]} (not gated)")
    return total


# -- phase 9 ------------------------------------------------------------------


def phase_profile(torch) -> None:
    """Where the main path's time goes, at the map batch's shape (B=8,
    S=4096, 128 new tokens, int8 cache): for one prefill forward and one
    decode step, the first call's time on a fresh model and cache, the
    wall time after it (CUDA events), the device's busy time and
    kernel count (torch.profiler), the card's SM clock, power draw and
    clock-limit reasons (nvidia-smi) during a run, and the kernels that take
    most of the time."""
    from torch.profiler import ProfilerActivity, profile

    from vnsum_tpu_torch.models.llama import (
        init_kv_cache,
        init_model,
        llama32_3b,
        prefill_positions,
    )
    from vnsum_tpu_torch.ops.decode_attention import flash_decode_attention
    from vnsum_tpu_torch.ops.flash_attention import flash_prefill_attention

    cfg = llama32_3b()
    dev = torch.device("cuda")
    G = cfg.q_per_kv
    B, S, fill = 8, 4096, 4096
    torch.cuda.empty_cache()  # start from an empty allocator, as the pipeline did
    model = init_model(cfg, 0, dev)
    cache = init_kv_cache(cfg, B, S + 128, quantized=True, device=dev)
    pads = torch.zeros(B, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, 256, (B, S), generator=gen, device=dev)
    positions = prefill_positions(pads, S)

    def prefill():
        model(tokens, positions, cache, 0, None, last_only=True,
              stacked_attention_fn=lambda q, c, li: flash_prefill_attention(
                  q, c, li, pads, G, 0, 0))

    def decode():
        model(tokens[:, -1:], positions[:, -1:] + 1, cache, fill, None,
              stacked_attention_fn=lambda q, c, li: flash_decode_attention(
                  q, c, li, pads, fill, G, 0))

    with torch.inference_mode():
        for name, fn, n in (("prefill forward", prefill, 2), ("decode step", decode, 10)):
            # the first call on a fresh model and cache, as each pipeline
            # batch's first forward is: allocator growth, first GEMMs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            wall = time_ms(torch, lambda i: fn(), n=n, reps=3)
            # the card's clock, power draw and clock-limit reasons, sampled
            # while it runs n more calls (a power-capped card clocks down)
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                 "--format=csv,noheader"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            )
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            card = smi.communicate(timeout=60)[0].strip()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            by_kernel: dict[str, float] = {}
            count = 0
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    count += 1
                    us = evt.time_range.elapsed_us()
                    by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us
            busy = sum(by_kernel.values()) / 1e3
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            busy_txt = (f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}% of wall)"
                        if count else "device busy not measured (no device events)")
            log(f"[profile] {name}: first call {first:.3f} ms, then wall {wall:.3f} ms, "
                f"{busy_txt}, {count} device ops; "
                f"card (SM clock, power, limit reasons) {card}; top: "
                + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))
    del model, cache
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card visible: chip_smoke.py runs on the card only", file=sys.stderr)
        return 2
    phase_environment(torch)
    phase_build()
    errs = phase_correctness(torch)
    phase_mutants()
    timing = phase_timing(torch, errs)
    launches, plain_summaries = phase_pipeline(torch)
    spec_launches, backend, prompts, oneshot = phase_spec_pipeline(torch, plain_summaries)
    slot_launches = phase_slot_loop(torch, backend, prompts, oneshot)
    del backend
    launches = {k: launches[k] + spec_launches[k] + slot_launches[k] for k in launches}
    phase_profile(torch)
    kernels = []
    for key, meta in KERNELS.items():
        kernels.append({
            **meta, "launches": launches[key], "max_abs_err": errs[key], **timing[key],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
