"""Rolling checkpoint manager with crash-tolerant restore (the JAX
package's ``checkpoint/manager.py`` on one card).

- ``save(step, state)``: atomic write + retention of the last ``keep`` steps.
  Retention never removes the checkpoint just written (even when ``keep`` is
  misconfigured to 0) and tolerates concurrent pruners — a file already gone
  is a success, not a crash.
- ``restore_latest()``: loads the newest readable checkpoint as CPU tensors.
  A truncated/corrupt newest checkpoint (crash mid-write on a non-atomic
  filesystem, torn copy) is *skipped with a warning* and the previous step is
  restored instead — an interrupted save costs at most ``ckpt_every`` steps
  of progress, never the whole run.

The reference's ``mesh=``/``specs=`` restore and ``shard_restore`` have no
counterpart: the port runs on one card. ``level`` is the compression level
of :func:`~repro_torch.checkpoint.store.save_pytree` (the reference's 3 by
default).
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Any, List

from repro_torch import obs
from repro_torch.checkpoint.store import (CheckpointCorrupt, load_pytree,
                                          save_pytree)

_PAT = re.compile(r"^step_(\d+)\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, level: int = 3):
        self.directory = directory
        self.keep = keep
        self.level = level
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.ckpt")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _PAT.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: Any) -> str:
        with obs.get_telemetry().span("ckpt.save", step=step):
            path = self._path(step)
            save_pytree({"step": step, "state": state}, path, level=self.level)
            # retention: keep >= 1 whatever the configuration says — pruning
            # the checkpoint that was just written would turn save() into
            # delete()
            keep = max(int(self.keep), 1)
            for s in self.steps()[:-keep]:
                if s == step:
                    continue
                try:
                    os.unlink(self._path(s))
                except FileNotFoundError:
                    pass  # a concurrent pruner/restart got there first
            return path

    def restore(self, step: int):
        with obs.get_telemetry().span("ckpt.restore", step=step):
            payload = load_pytree(self._path(step))
            return payload["step"], payload["state"]

    def restore_latest(self):
        """Restore the newest *readable* checkpoint.

        Walks steps newest-first; a corrupt or vanished file (crash between
        temp write and rename leaves only a ``.tmp``; a torn write fails the
        store checksum) is skipped with a warning and the previous step is
        tried. Returns None when no checkpoint can be read.
        """
        for step in reversed(self.steps()):
            try:
                return self.restore(step)
            except (CheckpointCorrupt, FileNotFoundError, EOFError,
                    OSError) as e:
                warnings.warn(
                    f"checkpoint step {step} unreadable ({e}); falling back "
                    f"to the previous step", RuntimeWarning, stacklevel=2)
        return None
