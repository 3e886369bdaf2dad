"""CheckpointManager (rotation, async save, preemption-safe resume) and
the straggler watchdog — counterpart of `repro.checkpointing.manager`.

  * save(step) is atomic: a kill at any instant leaves the latest
    complete checkpoint restorable;
  * latest_step() scans only complete manifests;
  * async save overlaps the host serialization with the next train steps;
    every leaf is copied to the host before the thread starts, so the
    in-place optimizer cannot race the writer;
  * restore() + DataPipeline.restore() resume bit-exact (same losses);
  * StepWatchdog flags straggling steps (> factor x running median).
"""
from __future__ import annotations

import glob
import os
import re
import threading
import time
from typing import Optional

import numpy as np
import torch

from . import checkpoint as ckpt


def _host_copy(tree):
    """A host copy of every tensor leaf (numpy leaves copied too)."""
    leaves = [leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
              else np.array(leaf) for _, leaf in ckpt._items(tree)]
    return ckpt._rebuild(tree, iter(leaves))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}")

    def all_steps(self) -> list:
        steps = []
        for m in glob.glob(os.path.join(self.dir, "ckpt_*.manifest.json")):
            g = re.search(r"ckpt_(\d+)\.manifest\.json$", m)
            if g and os.path.exists(m.replace(".manifest.json", ".npz")):
                steps.append(int(g.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        host_tree = _host_copy(tree)

        def _do():
            ckpt.save(self._path(step), host_tree, step=step, metadata=metadata)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def restore(self, target_tree, step: Optional[int] = None, device=None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, ckpt.restore(self._path(step), target_tree, device)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            for suffix in (".npz", ".manifest.json"):
                p = self._path(s) + suffix
                if os.path.exists(p):
                    os.unlink(p)


class StepWatchdog:
    """Flags straggler steps: duration > factor * running median."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.durations: list = []
        self.stragglers: list = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        hist = sorted(self.durations[-self.window:])
        is_straggler = bool(hist and dt > self.factor * hist[len(hist) // 2])
        self.durations.append(dt)
        if is_straggler:
            self.stragglers.append((step, dt))
        return is_straggler
