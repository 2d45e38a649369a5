"""Model summaries (port of radialog_tpu/utils/summary.py): parameter counts
and bytes per subtree of a tree of dicts, lists and tuples of tensors, in
the same strings as the JAX package."""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..train.optim import tree_leaves


def _leaf_size(x) -> tuple[int, int]:
    if isinstance(x, torch.Tensor):
        return x.numel(), x.element_size()
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return math.prod(x.shape), np.dtype(x.dtype).itemsize
    return 0, 0


def param_count(tree: Any) -> int:
    return sum(_leaf_size(leaf)[0] for leaf in tree_leaves(tree))


def param_bytes(tree: Any) -> int:
    return sum(n * b for n, b in (_leaf_size(leaf) for leaf in tree_leaves(tree)))


def summarize(tree: Any, depth: int = 1, _prefix: str = "") -> str:
    """Indented per-subtree parameter counts down to ``depth`` levels; a
    list or tuple shows its first element and its length."""
    lines = []

    def fmt(n):
        for unit in ("", "K", "M", "B"):
            if n < 1000:
                return f"{n:.1f}{unit}" if unit else str(n)
            n /= 1000
        return f"{n:.1f}T"

    def walk(node, name, level):
        lines.append(f"{'  ' * level}{name}: {fmt(param_count(node))} params, "
                     f"{param_bytes(node) / 1e6:.1f} MB")
        if level < depth and isinstance(node, dict):
            for k in node:
                walk(node[k], k, level + 1)
        elif level < depth and isinstance(node, (list, tuple)) and node:
            walk(node[0], "[0] (x%d)" % len(node), level + 1)

    walk(tree, _prefix or "model", 0)
    return "\n".join(lines)
