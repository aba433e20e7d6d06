"""Sharded training checkpoints (``torch.distributed.checkpoint``).

Counterpart of ``vnsum_tpu/train/checkpoint.py``, which writes orbax
checkpoints: atomic, versioned train-state checkpoints (params, optimizer
state and step counter) written and restored WITH their shardings, so a
restore on the same mesh resumes bit for bit without gathering the model
onto one rank.

The format is the port's own (DCP's ``.metadata`` and ``.distcp`` files
under one directory a step); neither package reads the other's. DCP saves
a plain tensor as replicated, so two ``model`` ranks' shards of one leaf
would collide: on a mesh of more than one rank each leaf goes in as a
``DTensor`` over the mesh's ``DeviceMesh``, ``Shard(dim)`` on each mesh
axis the trainer's ``param_specs`` shards it over (``model``; ``fsdp``,
the stacked-layer dim, under ZeRO-3) and ``Replicate()`` elsewhere. What orbax's
``CheckpointManager`` does for the JAX package is written out here: a step
is written under a temporary name and renamed by rank 0 once every rank is
done, and the oldest steps past ``max_to_keep`` are removed.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..core.logging import get_logger

logger = get_logger("vnsum.train.ckpt")

_TMP = ".tmp"
# files a rank writes at once (DCP's writer threads, each file synced)
WRITE_THREADS = 4


def _placed(mesh, t: torch.Tensor, spec: tuple):
    """``t`` as DCP should see it: itself on one rank; else a DTensor over
    the mesh, sharded on each axis ``spec`` names (a view, no copy)."""
    if mesh.device_mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = mesh.device_mesh
    placements = [Shard(spec.index(ax)) if ax in spec else Replicate()
                  for ax in dm.mesh_dim_names]
    return DTensor.from_local(t, dm, placements, run_check=False)


class TrainCheckpointer:
    """Versioned save/restore for a :class:`vnsum_tpu_torch.train.Trainer`.
    Every rank of the trainer's mesh calls ``save`` and ``restore``
    together; ``directory`` is one path that every rank sees."""

    def __init__(self, directory: str | Path, max_to_keep: int | None = 3) -> None:
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def _state(self, trainer) -> tuple[dict, dict]:
        """(the trainer's state as DCP's flat dict over its own tensors, each
        key's own tensor)."""
        state = {"step": torch.tensor(trainer.step_count),
                 "count": torch.tensor(trainer.optimizer.count)}
        own = {}
        for path, p, spec in trainer.leaves():
            name = "/".join(path)
            moments = trainer.optimizer.state[p]
            for kind, t in (("params", p.detach()), ("mu", moments["mu"]), ("nu", moments["nu"])):
                own[f"{kind}/{name}"] = t
                state[f"{kind}/{name}"] = _placed(trainer.mesh, t, spec)
        return state, own

    @staticmethod
    def _barrier(trainer) -> None:
        if trainer.mesh.device_mesh is not None:
            dist.barrier()

    def save(self, trainer, *, wait: bool = True) -> int:
        """Write a checkpoint at the trainer's current step; returns the
        step. The write is done when this returns, with ``wait`` or
        without (orbax's ``wait=False`` queues it)."""
        step = trainer.step_count
        final, tmp = self.directory / str(step), self.directory / f"{step}{_TMP}"
        if final.exists():
            raise FileExistsError(f"a checkpoint for step {step} exists under {self.directory}")
        primary = trainer.mesh.device_mesh is None or dist.get_rank() == 0
        if primary:
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier(trainer)
        dcp.save(self._state(trainer)[0],
                 storage_writer=dcp.FileSystemWriter(tmp, thread_count=WRITE_THREADS),
                 no_dist=trainer.mesh.device_mesh is None)
        self._barrier(trainer)
        if primary:
            tmp.rename(final)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self.directory / str(old))
        self._barrier(trainer)
        logger.info("saved checkpoint step=%d at %s", step, self.directory)
        return step

    def restore(self, trainer, step: int | None = None) -> int:
        """Restore params and optimizer state into ``trainer`` in place
        (each rank's shards stay where they are); returns the restored
        step."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        state, own = self._state(trainer)
        dcp.load(state, checkpoint_id=self.directory / str(step),
                 no_dist=trainer.mesh.device_mesh is None)
        for key, t in own.items():
            got = state[key]
            got = got.to_local() if got is not t else got
            if got.data_ptr() != t.data_ptr():  # loaded beside, not into, the tensor
                t.copy_(got)
        trainer.optimizer.count = int(state["count"])
        trainer.step_count = step
        logger.info("restored checkpoint step=%d from %s", step, self.directory)
        return step

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """The committed steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def close(self) -> None:
        """Nothing to release: every save is committed when it returns."""
