#!/usr/bin/env python3
"""Times the ring prefill with and without its skip of fully masked K/V
blocks, in one call on one card:

    python3 scripts/ring_compare.py

Two processes share card 0 over gloo, as ``chip_smoke.py`` phase 9h's
ranks do, and run ``backend/long_context.py`` ``long_prefill`` at that
phase's shape: Llama-3.2-3B at full width and 4 of its 28 layers (random
weights from seed 0), B=2, S=25,600 (12,800 slots a rank), left pads 771
and 5315. The arms run in the order skip / no skip / no skip / skip:

- ``skip``: the tree's ``parallel/ring.py``; rank 0 passes the block of
  rank 1's keys on without computing it (every key follows its queries);
- ``no skip``: the same source with the skip taken out (built here by
  text replacement into a temporary module), so every rank computes every
  block.

Each arm's wall is timed between two barriers, each rank synchronizing
the card first; every arm's last logits must equal the first arm's bit for
bit (the skip leaves the online softmax's state exactly as it is). Prints
the card's name and power limit, each arm's seconds, and exits 1 if the
logits differ.
"""
from __future__ import annotations

import datetime
import importlib.util
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SKIP = '''        if src > idx:
            # every key of the block comes after every query of this rank:
            # the causal mask hides it all, and the online softmax would
            # leave (m, l, o) exactly as they are (correction 1, p 0)
            if i < n - 1:
                k_cur, v_cur = group.ring_shift(k_cur), group.ring_shift(v_cur)
            continue
'''
ARMS = ("skip", "no skip", "no skip", "skip")
S, PADS, LAYERS = 25600, (771, 5315), 4


def no_skip_ring(tmp: str):
    """``ring_attention`` of the tree's ring.py with the skip taken out."""
    src = (ROOT / "vnsum_tpu_torch/parallel/ring.py").read_text()
    if src.count(SKIP) != 1:
        raise SystemExit("ring.py's skip is not once in its source")
    src = src.replace(SKIP, "").replace("from ..ops.", "from vnsum_tpu_torch.ops.") \
        .replace("from .seq ", "from vnsum_tpu_torch.parallel.seq ")
    path = Path(tmp) / "ring_no_skip.py"
    path.write_text(src)
    spec = importlib.util.spec_from_file_location("ring_no_skip", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ring_attention


def rank_main(rank: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=600))
    try:
        from vnsum_tpu_torch.backend import long_context as lc
        from vnsum_tpu_torch.models.llama import init_model, llama32_3b
        from vnsum_tpu_torch.parallel import SeqGroup, ring_attention

        rings = {"skip": ring_attention, "no skip": no_skip_ring(tmp)}
        group = SeqGroup(rank, 2, dist.group.WORLD)
        model = init_model(llama32_3b(n_layers=LAYERS), 0, "cuda")
        tokens = torch.randint(0, 256, (2, S), generator=torch.Generator().manual_seed(1))
        for b, p in enumerate(PADS):
            tokens[b, :p] = 258
        tokens, pads = tokens.cuda(), torch.tensor(PADS, dtype=torch.int32, device="cuda")
        out = []
        with torch.inference_mode():
            for arm in ARMS:
                lc.ring_attention = rings[arm]
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                logits, _ = lc.long_prefill(model, tokens, pads, group)
                torch.cuda.synchronize()
                dist.barrier()
                out.append((arm, time.perf_counter() - t0, logits.float().cpu()))
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible: ring_compare.py runs on the card only", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
        if [p.exitcode for p in procs] != [0, 0]:
            print(f"ranks exited {[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
    equal = True
    for i, arm in enumerate(ARMS):
        same = all(torch.equal(res[i][2], ranks[0][0][2]) for res in ranks)
        equal = equal and same
        print(f"[ring] {arm}: rank 0 {ranks[0][i][1]:.3f} s, rank 1 {ranks[1][i][1]:.3f} s, "
              f"last logits equal to the first arm's: {same}")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
