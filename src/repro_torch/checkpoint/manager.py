"""Checkpoint/restart manager: rotation, latest-valid restore.

As the reference's ``repro.checkpoint.manager``: training resumes after
losing any single shard per parity group of the newest checkpoint, or
the whole newest checkpoint (it falls back to the previous one).  A
checkpoint is visible only once its ``COMMITTED`` marker is written, so
a crash mid-save never shadows the previous good one.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Optional, Tuple

from repro_torch.checkpoint.ckpt import RestoreStats, restore, save


class CheckpointManager:
    def __init__(self, root, *, keep: int = 3, save_every: int = 100,
                 parity_group: int = 4, shard_bytes: int = 1 << 24,
                 pipelined_restore: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.save_every = save_every
        self.parity_group = parity_group
        self.shard_bytes = shard_bytes
        self.pipelined_restore = pipelined_restore
        self.last_save_s = 0.0

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:09d}"

    def steps(self):
        return [int(d.name.split("_")[1])
                for d in sorted(self.root.glob("step_*"))
                if (d / "manifest.json").exists()
                and (d / "COMMITTED").exists()]

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, state: Any) -> Path:
        d = self._dir(step)
        if d.exists():
            shutil.rmtree(d)
        t0 = time.perf_counter()
        save(d, state, parity_group=self.parity_group,
             shard_bytes=self.shard_bytes)
        (d / "COMMITTED").write_text(json.dumps({"step": step,
                                                 "t": time.time()}))
        self._gc()
        self.last_save_s = time.perf_counter() - t0
        (d / "SAVE_STATS").write_text(json.dumps({"save_s":
                                                  self.last_save_s}))
        return d

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def restore_latest(self, tree_like: Any, device=None
                       ) -> Tuple[Optional[int], Optional[Any],
                                  Optional[RestoreStats]]:
        """Restore the newest checkpoint that verifies; walk back on
        failure.  Tensors land on ``device`` (``None``: the CPU)."""
        for step in reversed(self.steps()):
            try:
                tree, stats = restore(self._dir(step), tree_like,
                                      pipelined=self.pipelined_restore,
                                      device=device)
                return step, tree, stats
            except (IOError, KeyError, json.JSONDecodeError):
                continue  # exceeded parity margin -> previous checkpoint
        return None, None, None
