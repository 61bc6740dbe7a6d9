"""Inputs of the `gl_long` configuration: gl.py's GL field, ParamNet
weights and batch plan, unchanged (the same field gives (2, 4, 4) = 32
patches of (50, 32, 32)).  Before any data is made, `make_data` checks that
the program's config class (`program.config`) takes every key of
PROGRAM_KEYS: a program without `downsample_first` would otherwise build
another hierarchy, whose coarsest level it cannot afford, instead of
failing."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import numpy as np

from perfbench.inputs.gl import batch_args, batch_plan, make_weights, weight_shapes  # noqa: F401
from perfbench.inputs.gl import make_data as gl_make_data

# the configuration's keys that the entry hands to the program's config
# class by name (entries/trainer_step.py)
PROGRAM_KEYS = ("solver_dim", "n_grid", "downsample_first", "nn_transform", "batch_size", "lr",
                "downsample")


def check_program(cfg: Dict) -> None:
    """Raises ValueError where the program's config class lacks a key of
    PROGRAM_KEYS."""
    prog = cfg["program"]
    cls = getattr(importlib.import_module(prog["module"]), prog["config"])
    missing = [k for k in PROGRAM_KEYS if k not in {f.name for f in dataclasses.fields(cls)}]
    if missing:
        raise ValueError(f"configuration {cfg['name']}: the program's {prog['config']} has no "
                         f"{', '.join(missing)}; it cannot run this configuration")


def make_data(cfg: Dict, seed: int, root: str, device) -> Dict[str, np.ndarray]:
    check_program(cfg)
    return gl_make_data(cfg, seed, root, device)
