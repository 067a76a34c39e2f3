"""Checkpointing: atomic save/restore of a tree of tensors with step
metadata — the port of the reference package's
``checkpoint/manager.py``, with its on-disk layout:

  * one ``.npy`` per leaf, named by the leaf's tree path (``/`` -> ``__``;
    paths from ``repro_torch.tree``: dict keys, list indices, NamedTuple
    field names), and a ``manifest.json`` with the step, the sorted keys
    and the caller's ``extra``;
  * atomicity — writes go to ``step_<n>.tmp/`` and are renamed to
    ``step_<n>/``; a crash mid-save never corrupts the latest checkpoint;
  * ``latest_step()`` — the highest complete step; a restart resumes
    there;
  * retention — the last ``keep`` checkpoints stay, older ones go.

``dist/fault.RestartableLoop`` relies on all three. On restore each leaf
takes the template leaf's dtype and device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, map_with_path, path_str


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _file(directory: str, key: str) -> str:
    return os.path.join(directory, key.replace("/", "__") + ".npy")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        final = self._dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = {path_str(p): _to_numpy(leaf)
                  for p, leaf in flatten_with_path(tree)}
        manifest = {"step": step, "keys": sorted(leaves),
                    "extra": extra or {}}
        for k, arr in leaves.items():
            np.save(_file(tmp, k), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``template`` (values ignored):
        every leaf a tensor with the template leaf's dtype and device (the
        CPU for a leaf that is not a tensor)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._dir(step)

        def load(path, leaf):
            t = torch.from_numpy(np.load(_file(d, path_str(path))))
            if isinstance(leaf, torch.Tensor):
                return t.to(device=leaf.device, dtype=leaf.dtype)
            return t
        return map_with_path(load, template)

    def extra(self, step: Optional[int] = None) -> Dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self._dir(step), "manifest.json")) as f:
            return json.load(f)["extra"]
