#!/usr/bin/env python3
"""Times one of the tree's kernels against an earlier version of its
source, in one process on one card:

    git show <commit>:vnsum_tpu_torch/ops/csrc/int8_gemv.cu > chip_archive/parent_gemv.cu
    python3 scripts/kernel_compare.py gemv chip_archive/parent_gemv.cu
    git show <commit>:vnsum_tpu_torch/ops/csrc/flash_verify.cu > chip_archive/parent_verify.cu
    python3 scripts/kernel_compare.py verify chip_archive/parent_verify.cu
    git show <commit>:vnsum_tpu_torch/ops/csrc/flash_prefill.cu > chip_archive/parent_prefill.cu
    python3 scripts/kernel_compare.py prefill chip_archive/parent_prefill.cu

The earlier source is built with the same nvcc flags as the tree's kernels
into a temporary directory. Every output is held to the plain version at
chip_smoke.py's limit for that kernel; the script prints the card's name and
power limit and exits 1 if one is over it.

``gemv``: the int8-weight GEMV at the launches of a Llama-3.2-3B decode
step. The earlier source must export ``vnsum_int8_gemv`` (one weight a
launch, the version before the grouped entry point). At M = 1, 8 and 72
rows, each from one replayed CUDA graph of 28 layers of weights in turn
(cold in L2, as a decode step finds them), it prints per launch of the step:

- ``tree``: the tree's kernel, q/k/v and gate/up as one grouped launch each
  (113 launches a step);
- ``earlier``: the earlier kernel, one launch a weight (197 a step);
- ``earlier, concatenated``: the earlier kernel once over q/k/v's and
  gate/up's weights laid side by side, what it would do with one launch a
  shared input (113 a step);

then each one's sum over a decode step at M = 8.

``verify``: K3 at Llama-3.2-3B's spec step (B=8, Sq=9, C=4233) and slot
segment (B=8, Sq=1, C=4224) at head_dim 128. The earlier source must export
``vnsum_flash_verify`` and ``vnsum_flash_verify_splits`` with the tree's
signatures (every version since the kernel's first has); it is swapped in
for the wrapper's library. Each shape runs chip_smoke.py's ``time_verify``
(an int8 cache of 28 layers called in turn, pads 64 b, its ``[time] verify
passes`` line giving pass 1 and the merge in device time) in the order
tree, earlier, earlier, tree, and prints each run's CUDA-event time a call.

``prefill``: K1 at head_dim 128 on an int8 cache of 28 layers called in
turn (pads 64 b), at Llama-3.2-3B's map batch (B=8, S=4096, C=4224,
q_offset 0) and at the prefix cache's resume shape (the same batch's last
512 queries a row at q_offset 3584, through chip_smoke.py's
``time_resume_prefill``). The earlier source must export
``vnsum_flash_prefill`` with the tree's signature; it is swapped in for the
wrapper's library, in the order tree, earlier, earlier, tree.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

L = 28
# the GEMV's launches in a decode step: name -> (channels of each member,
# K, launches a step)
LAUNCHES = {"q/k/v": ((3072, 1024, 1024), 3072, L), "wo": ((3072,), 3072, L),
            "gate/up": ((8192, 8192), 3072, L), "w_down": ((3072,), 8192, L),
            "head": ((128256,), 3072, 1)}


def earlier_library(source: Path, build: Path) -> ctypes.CDLL:
    """``source`` built with the tree's nvcc flags into ``build``."""
    from vnsum_tpu_torch.ops import kernels

    lib_path = build / f"libearlier_{source.stem}.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib_path), str(source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib_path))


def earlier_gemv(torch, lib: ctypes.CDLL):
    """The earlier source's one-weight entry point as fn(x, q, s, head)."""
    fn = lib.vnsum_int8_gemv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, q, s, head=False):
        (M, K), N = x.shape, q.shape[0]
        out = torch.empty((M, N), dtype=torch.float32 if head else x.dtype, device=x.device)
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K, int(head),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"earlier GEMV launch failed: CUDA error {rc}")
        return out

    return run


def compare_gemv(torch, lib: ctypes.CDLL, smi: str) -> None:
    from vnsum_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    earlier = earlier_gemv(torch, lib)
    steps = {"tree": 0.0, "earlier": 0.0, "earlier, concatenated": 0.0}
    for i, (name, (ns, K, per_step)) in enumerate(LAUNCHES.items()):
        head = name == "head"
        layers = 1 if head else L
        offs = [sum(ns[:j]) for j in range(len(ns))]
        qcat, scat = c.int8_weight(torch, sum(ns), K, 200 + i, dev, layers)

        def members(li):
            return [(qcat[li, o:o + n], scat[li, o:o + n]) for o, n in zip(offs, ns)]

        for M in (1, 8, 72):
            x = c.rand_q(torch, (M, K), 210 + M, dev)
            want = [im.int8_gemv_ref(x, q, s, head) for q, s in members(0)]
            runs = {
                "tree": lambda li: im.int8_gemv_group(x, members(li), head),
                "earlier": lambda li: [earlier(x, q, s, head) for q, s in members(li)],
                "earlier, concatenated": lambda li: [earlier(x, qcat[li], scat[li], head)],
            }
            row = []
            for label, fn in runs.items():
                got = fn(0)
                if label == "earlier, concatenated":
                    got = list(torch.split(got[0], list(ns), dim=1))
                for g, w, (q, s) in zip(got, want, members(0)):
                    mag = (x.double().abs() @ q.double().abs().t()) * s.double()
                    limit = c.GEMV_SUM_RTOL * mag + (0.0 if head else
                                                     c.GEMV_RTOL * w.double().abs())
                    if bool(((g.double() - w.double()).abs() > limit).any()):
                        c.FAILED.append(f"{label} {name} M={M}")
                ms = c.graph_ms(torch, lambda j: fn(j % layers), 2 * layers)
                if M == 8:
                    steps[label] += per_step * ms
                row.append(f"{label} {ms * 1e3:.2f} us")
            bound = (sum(ns) * K + 4 * sum(ns) + 2 * M * K) / c.PEAK_BYTES * 1e6
            print(f"[compare] {name} N={'+'.join(map(str, ns))} K={K} M={M}: bound "
                  f"{bound:.2f} us; " + "; ".join(row), flush=True)
        del qcat, scat
        torch.cuda.empty_cache()
    print("[compare] a decode step at M=8: " + "; ".join(
        f"{label} {ms:.4f} ms" for label, ms in steps.items()) + f" ({smi})", flush=True)


def compare_verify(torch, lib: ctypes.CDLL, smi: str) -> None:
    from vnsum_tpu_torch.ops import verify_attention as va

    lib.vnsum_flash_verify.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    lib.vnsum_flash_verify.restype = ctypes.c_int
    lib.vnsum_flash_verify_splits.argtypes = [ctypes.c_int]
    lib.vnsum_flash_verify_splits.restype = ctypes.c_int
    dev = torch.device("cuda")
    B, KV, G, hd, S = 8, 8, 3, 128, 4096
    pads_h = [64 * i for i in range(B)]
    worst = {"verify": 0.0}
    libs = {"tree": va._library(), "earlier": lib}
    for what, Sq, fills_h in (("spec", 9, [S + 60 + 3 * i for i in range(B)]),
                              ("slot", 1, [S + 16 * i for i in range(B)])):
        C = S + 128 + (Sq if Sq > 1 else 0)
        cache = c.make_cache(torch, L, B, KV, C, hd, True, 4, dev)
        k_lib, v_lib = c.library_kv(torch, cache, 4, G)
        times = {"tree": [], "earlier": []}
        for label in ("tree", "earlier", "earlier", "tree"):
            va._lib = libs[label]
            rec = c.time_verify(torch, worst, cache, k_lib, v_lib, pads_h, fills_h, Sq, 32)
            times[label].append(rec["ms"])
            print(f"[compare] verify {what} B={B} Sq={Sq} C={C} {label}: kernel "
                  f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms", flush=True)
        print(f"[compare] verify {what}: tree {times['tree']}, earlier {times['earlier']} "
              f"(CUDA events, ms a call; {smi})", flush=True)
        del cache, k_lib, v_lib
        torch.cuda.empty_cache()
    va._lib = libs["tree"]


def compare_prefill(torch, lib: ctypes.CDLL, smi: str) -> None:
    from vnsum_tpu_torch.ops import flash_attention as fa

    lib.vnsum_flash_prefill.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    lib.vnsum_flash_prefill.restype = ctypes.c_int
    dev = torch.device("cuda")
    B, KV, G, hd, S = 8, 8, 3, 128, 4096
    C = S + 128
    pads_h = [64 * i for i in range(B)]
    pads = torch.tensor(pads_h, dtype=torch.int32, device=dev)
    cache = c.make_cache(torch, L, B, KV, C, hd, True, 3, dev)
    lib_kv = c.library_kv(torch, cache, 4, G)
    q = c.rand_q(torch, (B, S, KV * G, hd), 5, dev)
    worst = {"prefill": 0.0, "prefill_resume": 0.0}
    libs = {"tree": fa._library(), "earlier": lib}
    for what in ("map batch", "resume"):
        times = {"tree": [], "earlier": []}
        for label in ("tree", "earlier", "earlier", "tree"):
            fa._lib = libs[label]
            if what == "resume":
                ms = c.time_resume_prefill(torch, worst, cache, lib_kv, pads_h, G,
                                           c.RESUME_OFFSETS[-1])["ms"]
            else:
                ms = c.time_ms(torch, lambda i: fa.flash_prefill_attention(
                    q, cache, i % L, pads, G, 0, 0), n=2 * L)
                c.compare(torch, "prefill", f"prefill {label} B={B} S={S} C={C} layer={L - 1}",
                          fa.flash_prefill_attention(q, cache, L - 1, pads, G, 0, 0),
                          fa.flash_prefill_attention_ref(q, cache, L - 1, pads, G, 0, 0), worst)
            times[label].append(ms)
            print(f"[compare] prefill {what} {label}: kernel {ms:.4f} ms", flush=True)
        print(f"[compare] prefill {what}: tree {times['tree']}, earlier {times['earlier']} "
              f"(CUDA events, ms a call; {smi})", flush=True)
    fa._lib = libs["tree"]


def main() -> int:
    import torch

    kernels = {"gemv": compare_gemv, "verify": compare_verify, "prefill": compare_prefill}
    if len(sys.argv) != 3 or sys.argv[1] not in kernels or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = c.phase_environment(torch)
    with tempfile.TemporaryDirectory() as build:
        kernels[sys.argv[1]](torch, earlier_library(Path(sys.argv[2]), Path(build)), smi)
    if c.FAILED:
        print(f"[compare] over chip_smoke's {sys.argv[1]} limit: {c.FAILED}", flush=True)
    return 1 if c.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
