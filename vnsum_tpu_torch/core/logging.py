"""Run logging: timestamped file + stdout, like the reference's setup_logging
(run_full_evaluation_pipeline.py:137-163), without mutating global state twice.

The stream handler is installed IDEMPOTENTLY on the "vnsum" root logger and
nowhere else: a previous version skipped installation whenever the GLOBAL
root logger had handlers, so any process that configured root logging first
(pytest's capture handler, absl's init, a user basicConfig) silently
suppressed every vnsum log line. Now the handler is keyed by a marker
attribute — repeated get_logger() calls never stack duplicates, and an
already-configured root cannot veto vnsum's own stream.

``VNSUM_LOG_JSON=1`` switches the stream handler to a structured JSONL
formatter (one JSON object per line: ts, level, logger, msg, plus exc_info
when present) for log pipelines that ingest structured events; the run-file
handler keeps the human-readable format either way.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_MARKER = "_vnsum_stream_handler"


class JsonFormatter(logging.Formatter):
    """One JSON object per record — stable keys, ISO-ish local timestamps."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(record.created)
            ),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def _stream_formatter() -> logging.Formatter:
    if os.environ.get("VNSUM_LOG_JSON") == "1":
        return JsonFormatter()
    return logging.Formatter(_FORMAT)


def get_logger(name: str = "vnsum") -> logging.Logger:
    """Child loggers propagate to the single handler on the "vnsum" root."""
    root = logging.getLogger("vnsum")
    if not any(getattr(h, _MARKER, False) for h in root.handlers):
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(_stream_formatter())
        setattr(h, _MARKER, True)
        root.addHandler(h)
        root.setLevel(logging.INFO)
        # vnsum owns its emission: without this, a process whose GLOBAL
        # root is also configured (basicConfig, absl) would print every
        # line twice — once here, once propagated to the root handler
        root.propagate = False
    return logging.getLogger(name)


_active_file_handler: logging.FileHandler | None = None


def setup_run_logging(logs_dir: str | Path, run_name: str = "pipeline_run") -> Path:
    """Attach a timestamped file handler to the root vnsum logger, replacing
    the handler from any previous run in this process.

    Returns the log file path (logs/<run_name>_<ts>.log).
    """
    global _active_file_handler
    logs = Path(logs_dir)
    logs.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    path = logs / f"{run_name}_{ts}.log"
    logger = logging.getLogger("vnsum")
    if _active_file_handler is not None:
        logger.removeHandler(_active_file_handler)
        _active_file_handler.close()
    fh = logging.FileHandler(path, encoding="utf-8")
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)
    logger.setLevel(logging.INFO)
    _active_file_handler = fh
    return path
