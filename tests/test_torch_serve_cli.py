"""The port's serving entry point, ``python -m vnsum_tpu_torch.serve.server``:
a real process on a free port answers /healthz and /v1/generate and exits 0
on SIGTERM after draining; the CLI refuses what is not ported by name, and
``--backend torch`` never lands on the CPU unless ``--device cpu`` asks."""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from vnsum_tpu_torch.serve.server import ServeState, main, make_server

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, timeout: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _post(url: str, payload: dict, timeout: float = 30.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_server_process_serves_and_drains_on_sigterm():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "vnsum_tpu_torch.serve.server", "--backend", "fake",
         "--inflight", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                health = _get(base + "/healthz", timeout=2)
                break
            except OSError:
                time.sleep(0.1)
        assert health is not None, "the server never answered /healthz"
        status, body = health
        assert status == 200 and body["status"] == "ok" and body["backend"] == "fake"
        status, body = _post(base + "/v1/generate",
                             {"prompt": "<content>\nxin chào thế giới\n</content>"})
        assert status == 200
        assert body["completions"][0]["text"] == "xin chào thế giới"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "draining" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


@pytest.mark.parametrize("argv,item", [
    (["--journal-dir", "j"], "A15b"),
    (["--journal-fsync-ms", "0"], "A15b"),
    (["--tenants", "a:1:0"], "A15b"),
    (["--preempt-budget", "4"], "A15b"),
    (["--slo", "ttft_p99=0.5"], "A15b"),
    (["--slo-burn-fast", "2"], "A15b"),
    (["--slo-burn-slow", "1"], "A15b"),
    (["--mesh", "data=2"], "A10"),
    (["--backend", "hf"], "A5c"),
])
def test_cli_refuses_unported_features_by_name(argv, item, capsys):
    args = argv if "--backend" in argv else ["--backend", "fake", *argv]
    with pytest.raises(SystemExit) as exc:
        main(args)
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
def test_torch_backend_without_device_cpu_raises_with_no_card():
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        main(["--backend", "torch", "--model", "tiny", "--max-new-tokens", "8"])


def test_torch_backend_on_cpu_serves_a_request(monkeypatch):
    """``--device cpu`` is the way onto the CPU: the CLI builds the engine
    the runner's way; served here in-process on a free port."""
    built = {}
    real = make_server

    def spy(state, host, port):
        built["state"] = state
        server = real(state, host, port)
        built["server"] = server
        return server

    monkeypatch.setattr("vnsum_tpu_torch.serve.server.make_server", spy)
    monkeypatch.setattr("vnsum_tpu_torch.serve.server.ThreadingHTTPServer.serve_forever",
                        lambda self: None)
    assert main(["--backend", "torch", "--device", "cpu", "--model", "tiny",
                 "--max-new-tokens", "8", "--port", "0", "--no-watchdog"]) == 0
    state: ServeState = built["state"]
    assert state.backend.name == "torch" and state.backend.device.type == "cpu"
    assert state.backend.max_new_tokens == 8
    # main closed the state on its way out: the scheduler is drained
    assert state.scheduler.closed


def test_in_process_server_on_torch_cpu_backend():
    from vnsum_tpu_torch.backend.engine import TorchBackend
    from vnsum_tpu_torch.models import llama as tl

    be = TorchBackend(model_config=tl.tiny_llama(), max_new_tokens=8, device="cpu")
    state = ServeState(be, max_batch=4, max_wait_s=0.005, watchdog=False)
    server = make_server(state, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, body = _post(base + "/v1/generate", {"prompt": "xin chào"})
        assert status == 200
        assert body["completions"][0]["text"] == be.generate(["xin chào"])[0]
    finally:
        server.shutdown()
        server.server_close()
        state.close()
