"""Captured decode steps: the one-token decode loop as CUDA graph replays.

Counterpart of the JAX package's compiled decode ``while_loop``
(``decode_part`` in ``vnsum_tpu/backend/engine.py``; the long-context decode
in ``vnsum_tpu/backend/long_context.py``). There the loop is one program and
the step counter a device value. Here a decode step (:func:`token_step`) is
a Python function that reads and writes only persistent device buffers
(:func:`decode_buffers`), the step counter ``t`` among them, and advances
``t`` itself; :func:`decode_loop` runs it:

- eagerly, one call a step (the CPU; the card's control run);
- or captured: step 0 runs eagerly as the warm-up (on a side stream), one
  more call is recorded into a ``torch.cuda.CUDAGraph``, and every later
  step is one ``replay()``, a single launch from the host.

Both read the all-done flag on the host every :data:`DONE_CHECK_INTERVAL`
steps. The steps after every row is done emit pad, so where the loop stops
never changes an output. A group's graph holds the addresses of its KV
cache and buffers, so it lives only as long as its loop.

Under the transfer guard (``analysis/sanitizers.py``) the all-done read is
an acknowledged ``device_get``, and a graph is recorded inside an
acknowledged section: CUDA refuses a sync inside a capture whatever the
sync debug mode says, and ``torch.cuda.graph`` synchronizes the device
before it begins, so the mode changes nothing that is recorded.

The kernel wrappers count a launch when Python calls them, which a replay
does not. :class:`CapturedStep` takes back what the capture counted and adds
it once per replay, so the counts stay those of the steps that ran; the
mesh wrappers' call counters (``ops/sharded.py``, :func:`read_calls`) alike.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..analysis.sanitizers import acknowledged, device_get
from ..ops import decode_attention, flash_attention, int8_matmul, sharded, verify_attention

# decode steps between host reads of the all-done flag (each read syncs)
DONE_CHECK_INTERVAL = 16

# launch counter name -> (module, attribute) of every kernel wrapper
_COUNTERS = {
    "prefill": (flash_attention, "launches"),
    "decode": (decode_attention, "launches"),
    "partials": (decode_attention, "partials_launches"),
    "verify": (verify_attention, "launches"),
    "gemv": (int8_matmul, "launches"),
}


# call counter name -> (module, attribute) of the mesh's K1/K2 wrappers
_CALLS = {
    "sharded_prefill": (sharded, "prefill_calls"),
    "sharded_decode": (sharded, "decode_calls"),
}


def read_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def read_calls() -> dict[str, int]:
    """The mesh wrappers' call counts."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _CALLS.items()}


def _set_launches(counts: dict[str, int], table=_COUNTERS) -> None:
    for name, (mod, attr) in table.items():
        setattr(mod, attr, counts[name])


def record_cuda_graph(step: Callable[[], None]) -> torch.cuda.CUDAGraph:
    """Record one call of ``step`` into a new CUDA graph; nothing runs."""
    graph = torch.cuda.CUDAGraph()
    with acknowledged(), torch.cuda.graph(graph):
        step()
    return graph


class CapturedStep:
    """``step`` recorded once into a CUDA graph (:func:`record_cuda_graph`)
    and run again by :meth:`replay`. ``launches`` holds what the recording
    counted, per kernel; the counters are put back to their values before
    it, and each replay adds ``launches`` to them."""

    def __init__(self, step: Callable[[], None]) -> None:
        # the graph reads the buffers ``step`` closes over: keep them alive
        self.step = step
        before, calls = read_launches(), read_calls()
        self.graph = record_cuda_graph(step)
        after, calls_after = read_launches(), read_calls()
        self.launches = {k: after[k] - before[k] for k in before}
        self.calls = {k: calls_after[k] - calls[k] for k in calls}
        _set_launches(before)
        _set_launches(calls, _CALLS)
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        _set_launches({k: v + self.launches[k] for k, v in read_launches().items()})
        _set_launches({k: v + self.calls[k] for k, v in read_calls().items()}, _CALLS)
        self.replays += 1


def warm_up(step: Callable[[], None], device: torch.device) -> None:
    """Run ``step`` once before its capture: on the card on a side stream,
    as PyTorch's CUDA graph notes ask, joined back to the current stream."""
    if device.type != "cuda":
        step()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)


def decode_buffers(cur: torch.Tensor, done: torch.Tensor, max_new: int, pad_id: int) -> dict:
    """A decode loop's persistent buffers: ``cur`` [B] int64, the token
    each row emits next; ``done`` [B] bool; ``out`` [B, max_new], the
    emitted ids, pad until written; ``t`` [1] int64, the step."""
    dev = cur.device
    return {
        "cur": cur, "done": done,
        "out": torch.full((cur.shape[0], max_new), pad_id, dtype=torch.long, device=dev),
        "t": torch.zeros((1,), dtype=torch.long, device=dev),
    }


def token_step(buffers: dict, eos: torch.Tensor, pad_id: int, forward, sample):
    """One-token decode over :func:`decode_buffers`, as ``step(t_host)``:
    emit ``cur`` (pad for done rows) into ``out`` at ``t``, mark rows whose
    token is a terminator (``eos``, a device tensor of ids) done, run
    ``forward(cur, t) -> logits [B, 1, V]`` (which writes the cache at the
    device ``t``), take ``sample(logits, t_host + 1)`` as the next ``cur``
    and advance ``t``. Every result lands in a buffer in place and every
    index is read on the device, so the function runs eagerly and as a
    replayed graph alike; ``t_host`` keys only sampled rows' generators,
    and greedy steps, the only captured ones, ignore it."""
    cur, done, out, t = buffers["cur"], buffers["done"], buffers["out"], buffers["t"]
    pad_fill = torch.full_like(cur, pad_id)

    def step(t_host: int) -> None:
        # emit, then the done check, then forward, then sample
        out.index_copy_(1, t, torch.where(done, pad_fill, cur)[:, None])
        done.logical_or_((cur[:, None] == eos[None, :]).any(dim=1))
        cur.copy_(sample(forward(cur, t), t_host + 1))
        t.add_(1)

    return step


def captures(gen, enabled: bool, required: bool) -> bool:
    """Whether a generation with config ``gen`` runs its decode steps
    captured, for a backend whose ``cuda_graphs`` resolved to ``enabled``
    (``required``: the caller asked for True). Greedy rows only: sampled
    ones draw from host-seeded generators every step, so they stay eager,
    and a backend that requires capture raises for them."""
    if gen.temperature <= 0:
        return enabled
    if required:
        raise ValueError(
            "cuda_graphs=True captures greedy decoding only; sampled rows "
            "draw from host-seeded generators every step"
        )
    return False


class LoopRun(NamedTuple):
    steps: int      # decode steps run, eager and replayed
    captures: int   # graphs recorded (0 or 1)
    replays: int    # steps run as replays


# hot path
def decode_loop(
    step: Callable[[int], None],
    done: torch.Tensor,
    max_new: int,
    *,
    capture: bool,
) -> LoopRun:
    """Run ``step(t)`` for t = 0 .. max_new - 1, stopping at the first
    all-done check (every DONE_CHECK_INTERVAL steps) that finds ``done``
    all true. ``step`` writes every result into persistent buffers, ``done``
    among them, and takes the host ``t`` only to key sampled rows; greedy
    steps ignore it, and only they are captured: with ``capture`` step 0
    runs eagerly as the warm-up, one call is recorded after it and steps 1,
    2, ... replay it. A failed capture or replay raises."""
    graph = None
    steps = 0
    for t in range(max_new):
        # lint-allow[host-sync-in-hot-path]: the all-done check every DONE_CHECK_INTERVAL steps, the on-device while_loop's exit in JAX
        if t % DONE_CHECK_INTERVAL == 0 and bool(device_get(done.all())):
            break
        if graph is not None:
            graph.replay()
        elif capture:
            warm_up(lambda: step(t), done.device)
            if t + 1 < max_new:
                graph = CapturedStep(lambda t=t: step(t + 1))
        else:
            step(t)
        steps += 1
    # the graph (its private memory pool with it) goes with this frame
    if graph is None:
        return LoopRun(steps, 0, 0)
    return LoopRun(steps, 1, graph.replays)
