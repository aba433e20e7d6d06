"""The port's lint suite (``vnsum_tpu_torch/analysis``) against the JAX
package's (``vnsum_tpu/analysis``).

Every case of ``tests/test_analysis_rules.py`` for the six copied rules
(guarded-by, swallowed-exception, unbounded-blocking-wait,
metric-label-cardinality, metrics-doc, durable-write) and the suppression
hygiene runs through both suites on the same snippet, placed under
``vnsum_tpu/...`` for the JAX rules and ``vnsum_tpu_torch/...`` for the
port's: the findings must be equal by (rule, line) and as many as the JAX
file pins. Then the torch counterparts of host-sync-in-hot-path and
device-pinning on their own snippets, the recorded exemptions (no
donation-safety or jit-recompile-hazard rule; metrics-doc's NOT_PORTED
mesh names), the CLI's exit codes, JSON and default path, and the port
clean under its own lint.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from vnsum_tpu.analysis.core import run_paths as jax_run_paths
from vnsum_tpu_torch.analysis.core import SourceFile, all_rules
from vnsum_tpu_torch.analysis.core import run_paths as port_run_paths
from vnsum_tpu_torch.analysis.rules import host_sync, metrics_doc

REPO_ROOT = Path(__file__).resolve().parents[1]

# -- the JAX file's snippets (tests/test_analysis_rules.py), verbatim --------

GUARDED_SRC = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []  # guarded by: _lock

        def good(self):
            with self._lock:
                self.items.append(1)

        def bad(self):
            self.items.append(2)

        def _drain_locked(self):
            # *_locked convention: caller holds the lock
            return len(self.items)
"""

GUARDED_ALIASES_SRC = """
    import threading

    class Q:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition(self._lock)
            self.items = []  # guarded by: _cond, _lock

        def via_cond(self):
            with self._cond:
                self.items.append(1)

        def via_lock(self):
            with self._lock:
                return len(self.items)
"""

SWALLOWED_SRC = """
    def handler(req, logger):
        try:
            dispatch(req)
        except Exception:
            logger.exception("oops")   # swallowed: future never resolves
"""

SWALLOWED_RESOLVES_SRC = """
    def a(req):
        try:
            dispatch(req)
        except Exception as e:
            req.future.set_exception(e)       # resolves the future

    def b(req):
        try:
            dispatch(req)
        except Exception:
            raise                              # re-raises

    def c(self, req):
        try:
            dispatch(req)
        except Exception as e:
            self._resolve_errored([req], e)    # resolver-helper convention

    def d(self):
        try:
            return primary()
        except TypeError:
            return fallback()                  # explicit fallback value

    def e(self, req):
        try:
            dispatch(req)
        except Exception as exc:
            self._json({"error": str(exc)}, 500)  # HTTP layer answers
"""

SWALLOWED_ALLOWED_SRC = """
    def handler(req, logger):
        try:
            dispatch(req)
        # lint-allow[swallowed-exception]: nothing was taken, nothing to resolve
        except Exception:
            logger.exception("oops")
"""

LABEL_SRC = """
    def render(self, lines, tenant, registry):
        lines.append(f'x_total{{tenant="{tenant}"}} 1')            # raw: flagged
        lines.append(f'y_total{{tenant="{registry.canonical(tenant)}"}} 1')
        for stage in ("queued", "resident"):
            lines.append(f'z_total{{stage="{stage}"}} 1')          # literal loop: fine
        for reason in SomeEnum:
            lines.append(f'w_total{{reason="{reason.value}"}} 1')  # enum .value: fine
        lines.append(f'plain interpolation with no label {tenant}')
"""

WORKER_LABEL_SRC = """
    def render(self, lines, name, registry):
        lines.append(f'a_total{{worker="{registry.canonical(name)}"}} 1')
        lines.append(f'b_total{{worker="{canonical(name)}"}} 1')
        lines.append(f'c_total{{worker="{name}"}} 1')              # raw: flagged
        for worker in SomeEnum:
            lines.append(f'd_total{{worker="{worker.value}"}} 1')  # enum: flagged
        for wname in ("w0", "w1"):
            lines.append(f'e_total{{worker="{wname}"}} 1')         # loop: flagged
"""

WORKER_CANONICAL_SRC = """
def render(self, lines, rows, registry):
    for r in rows:
        name = r["name"]
        lines.append(
            f'up{{worker="{registry.canonical(name, touch=False)}"}} 1'
        )
"""

UNBOUNDED_WAIT_SRC = """
    def loop(self, cond, ev, fut, q, d):
        cond.wait()                      # flagged: timeout-less Condition
        ev.wait()                        # flagged: timeout-less Event
        fut.result()                     # flagged: timeout-less Future
        q.get()                          # flagged: blocking Queue.get
        cond.wait(timeout=0.1)           # bounded: fine
        ev.wait(2.0)                     # positional timeout: fine
        fut.result(timeout=5)            # bounded: fine
        q.get(timeout=1.0)               # bounded: fine
        d.get("key")                     # dict.get with args: never matches
        d.get("key", None)               # ditto
        fut.result(timeout=None)         # spelled-out unboundedness: flagged
        ev.wait(None)                    # positional None: flagged too
"""

UNBOUNDED_ALLOWED_SRC = """
    def handler(self, fut):
        # lint-allow[unbounded-blocking-wait]: request futures are resolved by every scheduler path
        return fut.result()
"""

DURABLE_GOOD = """
    import os
    import tempfile

    # durable
    def atomic_write(path, text):
        fd, tmp = tempfile.mkstemp(dir=".")
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
"""

DURABLE_MISSING_FSYNC = """
    import os
    import tempfile

    def caller(path, text):  # unmarked helper: not checked
        open(path, "w").write(text)

    # durable
    def sloppy_write(path, text):
        fd, tmp = tempfile.mkstemp(dir=".")
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
        os.replace(tmp, path)
"""

DURABLE_APPEND_ONLY = """
    import os

    # durable: compaction-style rewrite
    def rewrite(path, lines):
        with open(path + ".tmp", "wb") as f:
            f.writelines(lines)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)

    def plain_append(f, line):  # no marker, no sequence required
        f.write(line)
"""

DURABLE_PROSE = """
    def notes():
        # durability is handled by the caller via atomic_write
        return 1
"""


def _guarded_allowed():
    return GUARDED_SRC.replace(
        "self.items.append(2)",
        "self.items.append(2)  # lint-allow[guarded-by]: "
        "single-writer fixture, lock not needed",
    )


def _label_allowed():
    return LABEL_SRC.replace(
        "lines.append(f'x_total{{tenant=\"{tenant}\"}} 1')",
        "# lint-allow[metric-label-cardinality]: fixture set is bounded\n"
        "        lines.append(f'x_total{{tenant=\"{tenant}\"}} 1')",
    )


def _durable_allowed():
    return DURABLE_MISSING_FSYNC.replace(
        "# durable",
        "# durable\n    # lint-allow[durable-write]: fixture exercises suppression",
    )


# (case id, rule or None for every rule, sub-path under the package or None
# for outside it, source, the finding count the JAX file pins)
COPIED_CASES = [
    ("guarded_flags_unlocked_only", "guarded-by", None, GUARDED_SRC, 1),
    ("guarded_suppression_clears", "guarded-by", None, _guarded_allowed(), 0),
    ("guarded_lock_aliases", "guarded-by", None, GUARDED_ALIASES_SRC, 0),
    ("suppression_unknown_rule", None, None, "x = 1  # lint-allow[not-a-rule]: because\n", 1),
    ("swallowed_log_and_continue", "swallowed-exception", "serve", SWALLOWED_SRC, 1),
    ("swallowed_resolution_forms", "swallowed-exception", "serve", SWALLOWED_RESOLVES_SRC, 0),
    ("swallowed_suppression", "swallowed-exception", "serve", SWALLOWED_ALLOWED_SRC, 0),
    ("swallowed_backend_in_scope", "swallowed-exception", "backend", SWALLOWED_SRC, 1),
    ("swallowed_out_of_scope", "swallowed-exception", None, SWALLOWED_SRC, 0),
    ("label_raw_dynamic_only", "metric-label-cardinality", "serve", LABEL_SRC, 1),
    ("label_scoped_to_serve", "metric-label-cardinality", "obs", LABEL_SRC, 0),
    ("label_suppression", "metric-label-cardinality", "serve", _label_allowed(), 0),
    ("label_worker_needs_canonical", "metric-label-cardinality", "serve", WORKER_LABEL_SRC, 3),
    ("label_worker_canonical_forms", "metric-label-cardinality", "serve", WORKER_CANONICAL_SRC,
     0),
    ("unbounded_every_primitive", "unbounded-blocking-wait", "serve", UNBOUNDED_WAIT_SRC, 6),
    ("unbounded_scoped_to_serve", "unbounded-blocking-wait", "backend", UNBOUNDED_WAIT_SRC, 0),
    ("unbounded_suppression", "unbounded-blocking-wait", "serve", UNBOUNDED_ALLOWED_SRC, 0),
    ("durable_full_sequence", "durable-write", None, DURABLE_GOOD, 0),
    ("durable_append_only", "durable-write", None, DURABLE_APPEND_ONLY, 0),
    ("durable_missing_fsync", "durable-write", None, DURABLE_MISSING_FSYNC, 1),
    ("durable_suppression", "durable-write", None, _durable_allowed(), 0),
    ("durable_marker_is_the_word", "durable-write", None, DURABLE_PROSE, 0),
]


def _both(tmp_path, sub, src, rules):
    """The snippet linted by the JAX suite under vnsum_tpu/<sub>/ and by the
    port's under vnsum_tpu_torch/<sub>/ (both at the top with no sub):
    each side's (rule, line) list."""
    out = []
    for pkg, run in (("vnsum_tpu", jax_run_paths), ("vnsum_tpu_torch", port_run_paths)):
        d = tmp_path / pkg / sub if sub else tmp_path / pkg
        d.mkdir(parents=True, exist_ok=True)
        f = d / "snippet.py"
        f.write_text(textwrap.dedent(src), encoding="utf-8")
        out.append([(x.rule, x.line) for x in run([f], root=tmp_path, rules=rules)])
    return out


@pytest.mark.parametrize("case", COPIED_CASES, ids=[c[0] for c in COPIED_CASES])
def test_copied_rule_matches_jax(tmp_path, case):
    _id, rule, sub, src, n = case
    jax_found, port_found = _both(tmp_path, sub, src, [rule] if rule else None)
    assert port_found == jax_found
    assert len(port_found) == n


def test_unbounded_wait_lines_match_the_jax_pin(tmp_path):
    _jax, port = _both(tmp_path, "serve", UNBOUNDED_WAIT_SRC, ["unbounded-blocking-wait"])
    assert [line for _r, line in port] == [3, 4, 5, 6, 13, 14]


def test_worker_label_lines_name_c_d_e(tmp_path):
    _jax, port = _both(tmp_path, "serve", WORKER_LABEL_SRC, ["metric-label-cardinality"])
    src_lines = textwrap.dedent(WORKER_LABEL_SRC).splitlines()
    assert [next(t for t in ("a_total", "b_total", "c_total", "d_total", "e_total")
                 if t in src_lines[line - 1]) for _r, line in port] == [
        "c_total", "d_total", "e_total"]


# -- metrics-doc (project rule) ----------------------------------------------


def _metrics_tree(root: Path, pkg: str, readme: str, extra: str = "") -> Path:
    serve = root / pkg / "serve"
    serve.mkdir(parents=True, exist_ok=True)
    (serve / "metrics.py").write_text(textwrap.dedent("""
        _reg("a_total", "counter", "a")
        _reg("lat_seconds", "histogram", "latency")
    """) + extra, encoding="utf-8")
    (root / "README.md").write_text(readme, encoding="utf-8")
    return root


@pytest.mark.parametrize("readme,n", [
    ("| vnsum_serve_a_total | vnsum_serve_lat_seconds_bucket | vnsum_serve_ghost_total |", 1),
    ("| vnsum_serve_a_total |", 1),
    ("| vnsum_serve_a_total | vnsum_serve_lat_seconds |", 0),
], ids=["bidirectional", "missing_registration", "clean"])
def test_metrics_doc_matches_jax(tmp_path, readme, n):
    found = []
    for pkg, run in (("vnsum_tpu", jax_run_paths), ("vnsum_tpu_torch", port_run_paths)):
        root = _metrics_tree(tmp_path / pkg, pkg, readme)
        found.append([(f.rule, f.line, Path(f.path).name, f.message)
                      for f in run([], root=root, rules=["metrics-doc"])])
    assert found[1] == found[0]
    assert len(found[1]) == n


def test_metrics_doc_not_ported_mesh_names_are_exempt(tmp_path):
    """The README's four vnsum_serve_mesh_* names are no finding for the
    port (ROADMAP A10); for the JAX rule over the same tree they are."""
    readme = "| vnsum_serve_a_total | vnsum_serve_lat_seconds |\n" + "\n".join(
        f"| vnsum_serve_{n} |" for n in sorted(metrics_doc.NOT_PORTED))
    assert set(metrics_doc.NOT_PORTED) == {
        "mesh_devices", "mesh_data_parallel", "mesh_model_parallel", "mesh_replica_occupancy"}
    assert all("A10" in why for why in metrics_doc.NOT_PORTED.values())
    port = _metrics_tree(tmp_path / "p", "vnsum_tpu_torch", readme)
    assert port_run_paths([], root=port, rules=["metrics-doc"]) == []
    jax = _metrics_tree(tmp_path / "j", "vnsum_tpu", readme)
    assert len(jax_run_paths([], root=jax, rules=["metrics-doc"])) == 4


def test_metrics_doc_exemption_goes_when_the_metric_comes(tmp_path):
    readme = "| vnsum_serve_a_total | vnsum_serve_lat_seconds | vnsum_serve_mesh_devices |"
    root = _metrics_tree(tmp_path, "vnsum_tpu_torch", readme,
                         extra='_reg("mesh_devices", "gauge", "cards")\n')
    found = port_run_paths([], root=root, rules=["metrics-doc"])
    assert len(found) == 1 and "NOT_PORTED" in found[0].message


def test_metrics_doc_holds_on_the_repo():
    """The real README against the port's registry: clean, and every name
    the JAX registry has and the port's lacks is a NOT_PORTED one."""
    assert port_run_paths([], root=REPO_ROOT, rules=["metrics-doc"]) == []
    jax = metrics_doc.registered_metrics(REPO_ROOT / "vnsum_tpu/serve/metrics.py")
    port = metrics_doc.registered_metrics(REPO_ROOT / metrics_doc.METRICS_REL)
    assert set(jax) - set(port) == set(metrics_doc.NOT_PORTED)


# -- host-sync-in-hot-path (the torch counterpart) ---------------------------


HOT_SRC = """
    import numpy as np
    import torch
    from vnsum_tpu_torch.analysis import sanitizers
    from vnsum_tpu_torch.analysis.sanitizers import device_get

    # hot path
    def decode_loop(x, done, n, flag, dev):
        a = x.item()
        b = x.cpu()
        c = x.tolist()
        d = x.numpy()
        e = np.asarray(x)
        if bool(done.all()):
            pass
        f = int((~done).sum())
        g = float(x.max())
        torch.cuda.synchronize()
        h = device_get(x)
        sanitizers.device_sync(dev)
        ok1 = int(n)
        ok2 = bool(flag)
        ok3 = x.block_until_ready()
        return a, b, c, d, e, f, g, h, ok1, ok2, ok3

    def cold(x):
        return x.item(), x.cpu(), np.asarray(x), bool(x.all())
"""


def _port(tmp_path, src, rules=("host-sync-in-hot-path",), rel="snippet.py"):
    f = tmp_path / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(src), encoding="utf-8")
    return port_run_paths([f], root=tmp_path, rules=list(rules) if rules else None)


def test_host_sync_flags_every_torch_sync_shape_in_hot_functions_only(tmp_path):
    found = _port(tmp_path, HOT_SRC)
    lines = textwrap.dedent(HOT_SRC).splitlines()
    flagged = [lines[f.line - 1].strip() for f in found]
    assert flagged == [
        "a = x.item()", "b = x.cpu()", "c = x.tolist()", "d = x.numpy()",
        "e = np.asarray(x)", "if bool(done.all()):", "f = int((~done).sum())",
        "g = float(x.max())", "torch.cuda.synchronize()", "h = device_get(x)",
        "sanitizers.device_sync(dev)",
    ]
    assert all("decode_loop" in f.message for f in found)


def test_host_sync_sees_a_marker_between_decorator_and_def(tmp_path):
    src = """
        import torch

        class E:
            @torch.inference_mode()
            # hot path
            def generate(self, x):
                return x.cpu()

            # hot path
            @torch.inference_mode()
            def hidden(self, x):
                return x.cpu()
    """
    found = _port(tmp_path, src)
    # a marker above the decorator names the decorator's line, not the
    # def's: the rule (like the JAX one) reads the def line and the line
    # above it only
    assert [f.message.split("'")[1] for f in found] == ["generate"]


def test_host_sync_suppression_needs_reason(tmp_path):
    src = """
        # hot path
        def decode_loop(x):
            # lint-allow[host-sync-in-hot-path]: the loop's exit condition
            return x.cpu()
    """
    assert _port(tmp_path, src, rules=None) == []
    bare = src.replace(": the loop's exit condition", ":")
    assert {f.rule for f in _port(tmp_path, bare, rules=None)} == {
        "host-sync-in-hot-path", "suppression"}


def test_every_hot_path_marker_in_the_port_is_seen():
    """Each ``# hot path`` comment in the port marks a function the rule
    scans: a marker the rule cannot see (above a decorator) checks
    nothing."""
    for path in sorted((REPO_ROOT / "vnsum_tpu_torch").rglob("*.py")):
        sf = SourceFile.read(path)
        markers = [ln for ln, c in sf.comments.items() if host_sync.HOT_RE.search(c)
                   and c.strip() == "# hot path"]
        if not markers:
            continue
        hot = {fn.lineno for fn in ast.walk(sf.tree)
               if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
               and host_sync._is_hot(sf, fn)}
        assert len(hot) == len(markers), path


def test_the_engine_hot_paths_are_the_jax_engines():
    names = set()
    for rel in ("backend/engine.py", "backend/inflight.py", "backend/capture.py"):
        sf = SourceFile.read(REPO_ROOT / "vnsum_tpu_torch" / rel)
        names |= {fn.name for fn in ast.walk(sf.tree)
                  if isinstance(fn, ast.FunctionDef) and host_sync._is_hot(sf, fn)}
    assert {"generate", "score_choices", "admit", "step"} <= names
    assert {"_run_group", "_run_group_spec", "_slot_segment", "decode_loop"} <= names


# -- device-pinning (the torch counterpart) ----------------------------------


PIN_SRC = """
    import torch

    def place(x, dev):
        a = x.to("cuda:0")                      # flagged
        b = torch.device("cuda", 0)             # flagged
        c = torch.device("cuda", index=0)       # flagged
        d = x.cuda()                            # flagged: the current card
        torch.cuda.set_device(0)                # flagged
        ok1 = x.to(dev)
        ok2 = torch.device("cuda")
        ok3 = x.cuda(dev)
        ok4 = torch.device("cuda", dev.index)
        torch.cuda.set_device(dev)
        return a, b, c, d, ok1, ok2, ok3, ok4
"""


def test_device_pinning_flags_each_pin(tmp_path):
    found = _port(tmp_path, PIN_SRC, rules=["device-pinning"], rel="backend/snippet.py")
    assert [f.line for f in found] == [5, 6, 7, 8, 9]
    assert {f.rule for f in found} == {"device-pinning"}


@pytest.mark.parametrize("rel,n", [("backend/snippet.py", 5), ("cache/snippet.py", 5),
                                   ("parallel/snippet.py", 0), ("snippet.py", 0)])
def test_device_pinning_scope(tmp_path, rel, n):
    assert len(_port(tmp_path, PIN_SRC, rules=["device-pinning"], rel=rel)) == n


def test_device_pinning_suppression_with_reason_clears(tmp_path):
    src = """
        def place(x):
            # lint-allow[device-pinning]: fixture pins deliberately
            return x.to("cuda:0")
    """
    assert _port(tmp_path, src, rules=["device-pinning"], rel="cache/snippet.py") == []


# -- exemptions ----------------------------------------------------------------


def test_the_rule_set_is_the_jax_one_less_the_exemptions():
    from vnsum_tpu.analysis.core import all_rules as jax_all_rules
    from vnsum_tpu_torch.analysis import rules

    jax, port = set(jax_all_rules()), set(all_rules())
    assert jax - port == {"donation-safety", "jit-recompile-hazard"}
    assert port == jax - {"donation-safety", "jit-recompile-hazard"}
    doc = rules.__doc__
    for name in ("donation-safety", "jit-recompile-hazard", "jax_cache.py", "NOT_PORTED"):
        assert name in doc


def test_an_exempt_rule_is_unknown_to_the_port(tmp_path):
    with pytest.raises(ValueError, match="donation-safety"):
        port_run_paths([tmp_path], root=tmp_path, rules=["donation-safety"])
    found = _port(tmp_path, "x = 1  # lint-allow[jit-recompile-hazard]: jax only\n",
                  rules=None)
    assert [f.rule for f in found] == ["suppression"]


# -- CLI -----------------------------------------------------------------------


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "vnsum_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO_ROOT)


def test_cli_json_output_and_exit_code(tmp_path):
    (tmp_path / "snippet.py").write_text(textwrap.dedent("""
        # hot path
        def decode_loop(x):
            return x.cpu()
    """), encoding="utf-8")
    proc = _cli("--json", "--root", str(tmp_path), str(tmp_path))
    assert proc.returncode == 1
    findings = json.loads(proc.stdout)
    assert [(f["rule"], f["line"]) for f in findings] == [("host-sync-in-hot-path", 4)]


def test_cli_fails_loudly_on_bad_path_and_rule():
    proc = _cli("does_not_exist")
    assert proc.returncode == 2 and "does_not_exist" in proc.stderr
    proc = _cli("--rule", "donation-safety", "vnsum_tpu_torch")
    assert proc.returncode == 2 and "donation-safety" in proc.stderr


def test_cli_lists_the_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    assert sorted(line.split()[0] for line in proc.stdout.splitlines()) == sorted(all_rules())


def test_port_is_clean_under_its_own_lint():
    """Acceptance: `python -m vnsum_tpu_torch.analysis vnsum_tpu_torch` and
    the bare CLI (its default path) exit 0 on this repo: every annotation
    holds and every suppression carries a written reason."""
    for args in (("vnsum_tpu_torch",), ()):
        proc = _cli(*args)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.strip() == "ok: no findings"


def test_port_suppressions_all_carry_reasons():
    """Every lint-allow in the port names one of its rules and a reason
    (the suppression rule's own check, counted here)."""
    from vnsum_tpu_torch.analysis.core import SUPPRESS_RE

    seen = 0
    for path in (REPO_ROOT / "vnsum_tpu_torch").rglob("*.py"):
        for line, comment in SourceFile.read(path).comments.items():
            m = SUPPRESS_RE.search(comment)
            if m:
                seen += 1
                assert m.group(1) in all_rules() and m.group(2).strip(), (path, line)
    assert seen >= 20
