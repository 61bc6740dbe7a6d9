"""Checkpoint/resume with torch.save (the JAX package uses orbax).

Each checkpoint is one file, <run_dir>/ckpt/<step>.pt, holding a dict of
state dicts.  A save writes a temporary file in the same directory and
renames it over the final name (`os.replace`), so a crash mid-save never
leaves a half-written checkpoint under a step's name; the newest
`max_to_keep` checkpoints are kept.  Restores load with `weights_only=True`
(tensors and plain containers only, no pickled code)."""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class Checkpointer:
    def __init__(self, run_dir: str, max_to_keep: int = 3):
        self.path = os.path.abspath(os.path.join(run_dir, "ckpt"))
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _file(self, step: int) -> str:
        return os.path.join(self.path, f"{step}.pt")

    def steps(self) -> List[int]:
        """Steps with a complete checkpoint, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.path)) if m)

    def save(self, step: int, state: Any) -> None:
        tmp = os.path.join(self.path, f".{step}.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, self._file(step))
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._file(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The checkpoint at `step` (default: the latest), its tensors on
        `map_location`; None if there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._file(step), map_location=map_location, weights_only=True)
