"""Checkpointing (port of radialog_tpu/core/checkpoint.py): the same
directory layout (``directory/<name or step_N>/`` beside
``<name or step_N>.meta.json``) and best/last retention, with the tree
written by ``torch.save`` instead of orbax. A checkpoint of the JAX package
is not readable here; bridge.py carries trees across.

Trees are nested dicts, lists and tuples of tensors and Python numbers. A
named tuple is saved as a plain tuple, so a file loads with
``weights_only=True``.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

TREE_FILE = "tree.pt"


def _plain(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_plain(v) for v in tree) if isinstance(tree, tuple) \
            else [_plain(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _like(tree: Any, target: Any) -> Any:
    """Leaves of ``tree`` with the dtype and device of ``target``'s."""
    if isinstance(target, dict):
        return {k: _like(tree[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        out = [_like(t, v) for t, v in zip(tree, target)]
        if hasattr(target, "_fields"):
            return type(target)(*out)
        return type(target)(out)
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(tree).to(device=target.device, dtype=target.dtype)
    return tree


def save_checkpoint(directory: Union[str, Path], step: int, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None,
                    name: Optional[str] = None) -> Path:
    """Write ``tree`` to directory/(name or step_N)/ and its metadata beside it."""
    directory = Path(directory)
    tag = name if name is not None else f"step_{step}"
    path = (directory / tag).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{TREE_FILE}.{os.getpid()}.tmp"
    torch.save(_plain(tree), tmp)
    os.replace(tmp, path / TREE_FILE)
    meta = {"step": int(step), **(metadata or {})}
    (directory / f"{tag}.meta.json").write_text(json.dumps(meta))
    return path


def load_checkpoint(directory: Union[str, Path], name: str = "last",
                    target: Optional[Any] = None) -> Tuple[Any, Dict[str, Any]]:
    """Load directory/name; ``target`` (a matching tree) gives the dtypes,
    devices and tuple types to restore. Returns (tree, metadata)."""
    directory = Path(directory)
    tree = torch.load((directory / name).absolute() / TREE_FILE, map_location="cpu",
                      weights_only=True)
    if target is not None:
        tree = _like(tree, target)
    meta_path = directory / f"{name}.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return tree, meta


def latest_step(directory: Union[str, Path]) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.glob("step_*.meta.json"):
        try:
            steps.append(int(p.stem.split("_")[1].split(".")[0]))
        except (IndexError, ValueError):
            continue
    return max(steps) if steps else None


class BestKeeper:
    """Keeps the last checkpoint and the best one by a metric."""

    def __init__(self, directory: Union[str, Path], mode: str = "max"):
        self.directory = Path(directory)
        self.mode = mode
        self.best: Optional[float] = None

    def update(self, step: int, metric: float, tree: Any,
               metadata: Optional[Dict] = None) -> bool:
        save_checkpoint(self.directory, step, tree,
                        {**(metadata or {}), "metric": metric}, name="last")
        improved = (self.best is None or
                    (metric > self.best if self.mode == "max" else metric < self.best))
        if improved:
            self.best = metric
            save_checkpoint(self.directory, step, tree,
                            {**(metadata or {}), "metric": metric}, name="best")
        return improved
