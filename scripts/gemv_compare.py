#!/usr/bin/env python3
"""Times the tree's int8-weight GEMV against an earlier version of its
source, in one process on one card, at the launches of a Llama-3.2-3B
decode step.

    git show <commit>:vnsum_tpu_torch/ops/csrc/int8_gemv.cu > chip_archive/parent_gemv.cu
    python3 scripts/gemv_compare.py chip_archive/parent_gemv.cu

The earlier source must export ``vnsum_int8_gemv`` (one weight a launch,
the version before the grouped entry point). It is built with the same
nvcc flags as the tree's kernels into a temporary directory. At M = 1, 8
and 72 rows, each from one replayed CUDA graph of 28 layers of weights in
turn (cold in L2, as a decode step finds them), the script prints per
launch of the step:

- ``tree``: the tree's kernel, q/k/v and gate/up as one grouped launch each
  (113 launches a step);
- ``earlier``: the earlier kernel, one launch a weight (197 a step);
- ``earlier, concatenated``: the earlier kernel once over q/k/v's and
  gate/up's weights laid side by side, what it would do with one launch a
  shared input (113 a step);

then each one's sum over a decode step at M = 8, and the card's name and
power limit. Every output is held to the plain version at chip_smoke.py's
GEMV limit; the script exits 1 if one is over it.
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
# the step's launches: name -> (channels of each member, K, launches a step)
LAUNCHES = {"q/k/v": ((3072, 1024, 1024), 3072, L), "wo": ((3072,), 3072, L),
            "gate/up": ((8192, 8192), 3072, L), "w_down": ((3072,), 8192, L),
            "head": ((128256,), 3072, 1)}


def earlier_kernel(torch, source: Path, build: Path):
    """The earlier source's one-weight entry point as fn(x, q, s, head)."""
    from vnsum_tpu_torch.ops import kernels

    lib_path = build / "libearlier.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib_path), str(source)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).vnsum_int8_gemv
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


def main() -> int:
    import torch

    from vnsum_tpu_torch.ops import int8_matmul as im

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    c.phase_environment(torch)
    dev = torch.device("cuda")
    steps = {"tree": 0.0, "earlier": 0.0, "earlier, concatenated": 0.0}
    with tempfile.TemporaryDirectory() as build:
        earlier = earlier_kernel(torch, Path(sys.argv[1]), Path(build))
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
        f"{label} {ms:.4f} ms" for label, ms in steps.items()), flush=True)
    if c.FAILED:
        print(f"[compare] over chip_smoke's GEMV limit: {c.FAILED}", flush=True)
    return 1 if c.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
