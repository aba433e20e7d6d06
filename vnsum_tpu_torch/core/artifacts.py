"""Crash-safe artifact writes: write-temp + fsync + ``os.replace``.

Copy of ``vnsum_tpu/core/artifacts.py``.

Every bench/runbook artifact in this repo is a JSON file some later run (or
the CI no-worse guard) reads back; a plain ``Path.write_text`` interrupted
by a crash leaves a truncated file that poisons the next resume (the
north-star runner checkpoints after every approach exactly to survive
crashes — a torn checkpoint would defeat it). These helpers make the write
atomic: the complete new content lands in a temp file in the SAME directory
(``os.replace`` is only atomic within a filesystem), is fsynced, and then
renamed over the target — a reader sees the old file or the new file, never
a prefix.

The ``# durable`` markers name the functions that carry the full
write+flush+fsync+replace sequence (the JAX package's ``durable-write``
lint checks its own copy; the port's lint is ROADMAP A14).
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path


# durable
def atomic_write_text(path: str | Path, text: str,
                      encoding: str = "utf-8") -> Path:
    """Atomically replace ``path`` with ``text``; parents are created."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=str(path.parent), prefix=path.name + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w", encoding=encoding) as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(path.parent)
    return path


def atomic_write_json(path: str | Path, obj, indent: int | None = 2) -> Path:
    """Atomically write ``obj`` as JSON (trailing newline, like the benches
    have always committed their artifacts)."""
    return atomic_write_text(
        path, json.dumps(obj, indent=indent, ensure_ascii=False) + "\n"
    )


def fsync_dir(directory: str | Path) -> None:
    """Make a rename in ``directory`` itself durable; best-effort on
    platforms whose directories can't be opened (Windows). Shared by the
    atomic writers here and the journal's compaction (serve/journal.py)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
