"""A watch on the files a process writes, for checks that a rank of a
mesh leaves the run's directories alone.

:class:`WriteWatch` is an audit hook (``sys.addaudithook``): while ``on``,
it records every write under ``root`` that Python's audit events report,
files opened for writing and directories made, files renamed or removed.
An audit hook cannot be removed, so a watch lives as long as its process:
tests and the card check install one in a process of its own.
"""
from __future__ import annotations

import os
import sys

# the audit events of a write other than ``open``
_WRITE_EVENTS = ("os.mkdir", "os.rename", "os.remove")


class WriteWatch:
    def __init__(self, root: str) -> None:
        self.root, self.on, self.seen = str(root), False, []
        sys.addaudithook(self)

    def __call__(self, event: str, args) -> None:
        if not self.on:
            return
        if event == "open":
            path, mode, flags = args
            writing = (any(c in mode for c in "wax+") if isinstance(mode, str)
                       else bool((flags or 0) & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
        elif event in _WRITE_EVENTS:
            path, writing = args[0], True
        else:
            return
        if (writing and isinstance(path, (str, bytes, os.PathLike))
                and os.fsdecode(path).startswith(self.root)):
            self.seen.append((event, os.fsdecode(path)))
