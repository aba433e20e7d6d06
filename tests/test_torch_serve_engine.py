"""The serving slice as a whole on carried tiny weights: the port's
ServeState over TorchBackend(device="cpu") against the JAX package's
ServeState over TpuBackend(interpret=True), through both HTTP servers.

In the batch, in-flight, prefix-cache and spec (``--spec-k 4`` with
references) modes every request's text equals the JAX server's and the
port's solo one-shot ``generate``, byte for byte, in f32. tiny_llama at
max_seq_len 128 with 24 new tokens keeps every cache within one 128-slot
block (the batch path's S = 64 bucket: C = 88, the spec path's C = 93, the
slot loop's S = 104: C = 128): the JAX kernels' interpret mode pads a
ragged last block with NaN. The JAX side's interpret dispatches are slow,
so both watchdogs get a generous dispatch budget.
"""
from __future__ import annotations

import json
import threading
import urllib.request

import pytest

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.serve.server import ServeState as JaxServeState
from vnsum_tpu.serve.server import make_server as jax_make_server
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.serve.server import ServeState, make_server

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

PROMPTS = [
    "văn bản một về kinh tế",
    "hai",
    "văn bản thứ ba dài hơn một chút về xã hội",
    "bốn bốn",
    "năm năm năm",
    "sáu và bảy",
]
REFS = [
    "văn bản một về kinh tế xã hội và phát triển bền vững",
    None,
    "văn bản thứ ba dài hơn một chút về xã hội và đời sống",
    "bốn bốn bốn bốn",
    None,
    "sáu và bảy và tám",
]
NEW = 24
MODES = {
    "batch": dict(backend={}, state={}),
    "inflight": dict(backend={}, state=dict(inflight=True, slots=4)),
    "cache": dict(backend=dict(cache_blocks=32, cache_block_tokens=8), state={}),
    "spec": dict(backend=dict(spec_k=4), state=dict(default_spec_k=4)),
}
# generous: an interpret-mode JAX dispatch on a busy host takes seconds
WATCHDOG = dict(watchdog_dispatch_base_s=600.0, watchdog_stall_s=600.0)


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=128)


def _backend(side, carried, spec_k=0, **kw):
    jcfg, params, model = carried
    common = dict(batch_size=8, max_new_tokens=NEW, seed=1, **kw)
    if side == "jax":
        return TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True,
                          generation=JaxGenerationConfig(spec_k=spec_k), **common)
    return TorchBackend(model=model, flash=True, device="cpu",
                        generation=GenerationConfig(spec_k=spec_k), segment_tokens=4, **common)


@pytest.fixture(scope="module", params=list(MODES))
def servers(request, carried):
    """(mode, port base, JAX base, port state, solo texts)."""
    mode = MODES[request.param]
    out = []
    for side, state_cls, server_fn in (("port", ServeState, make_server),
                                       ("jax", JaxServeState, jax_make_server)):
        be = _backend(side, carried, **mode["backend"])
        state = state_cls(be, max_batch=8, max_wait_s=0.02, **WATCHDOG, **mode["state"])
        server = server_fn(state, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append((f"http://127.0.0.1:{server.server_address[1]}", state, server))
    # the solo one-shot reference: a fresh port engine, one prompt a call
    solo_be = _backend("port", carried, **{k: v for k, v in mode["backend"].items()
                                            if k == "spec_k"})
    spec = mode["backend"].get("spec_k", 0) > 0
    solo = [solo_be.generate([p], references=[r] if spec else None)[0]
            for p, r in zip(PROMPTS, REFS)]
    yield request.param, out[0][0], out[1][0], out[0][1], solo
    for _base, state, server in out:
        server.shutdown()
        server.server_close()
        state.close(drain_timeout_s=60)


def _post(base, payload):
    req = urllib.request.Request(base + "/v1/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _payload(mode, idx):
    if mode == "spec":
        return {"prompts": [PROMPTS[i] for i in idx], "references": [REFS[i] for i in idx]}
    return {"prompts": [PROMPTS[i] for i in idx]}


def test_one_request_of_every_prompt_matches_jax_and_solo(servers):
    mode, port, jax, _state, solo = servers
    texts = []
    for base in (port, jax):
        status, body = _post(base, _payload(mode, range(len(PROMPTS))))
        assert status == 200
        texts.append([c["text"] for c in body["completions"]])
    assert texts[0] == texts[1] == solo
    assert any(texts[0])  # the carried weights emit text


def test_concurrent_requests_match_jax_and_solo(servers):
    """Six clients at once: the scheduler coalesces them (or slots them in
    as they come), and each still gets its solo text."""
    mode, port, jax, _state, solo = servers
    for base in (port, jax):
        got: dict = {}

        def run(i, base=base, got=got):
            got[i] = _post(base, _payload(mode, [i]))

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert all(not t.is_alive() for t in threads)
        assert [got[i][0] for i in range(len(PROMPTS))] == [200] * len(PROMPTS)
        assert [got[i][1]["completions"][0]["text"] for i in range(len(PROMPTS))] == solo


def test_port_trace_holds_the_engine_spans(servers):
    """The port's engine emits its spans onto the request's trace: a
    sync-bounded prefill anchors TTFT, and the decode shows as decode_seg
    (the spec path's as spec_prefill / spec_step)."""
    mode, port, _jax, state, _solo = servers
    _post(port, _payload(mode, [0]))
    with urllib.request.urlopen(port + "/debug/trace", timeout=30) as resp:
        doc = json.loads(resp.read())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    want = {"spec_prefill", "spec_step"} if mode == "spec" else {"prefill", "decode_seg"}
    assert want <= names
    if mode in ("batch", "cache"):
        assert {"tokenize", "dispatch", "detokenize"} <= names
    if mode == "cache":
        assert "cache_lookup" in names
    snap = state.metrics.snapshot()
    assert snap.completed >= 1 and snap.errors == 0
    # anchored TTFTs reached the histogram
    assert state.metrics.histograms_snapshot()["ttft_seconds"]["count"] >= 1
