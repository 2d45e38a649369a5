"""PRNG handling: one seed in, deterministic numbered and named streams out
(port of radialog_tpu/core/prng.py).

The JAX package threads explicit keys; the port threads ``torch.Generator``s.
``PRNGSeq(seed)()`` hands out a fresh generator at each call and
``PRNGSeq(seed)("dropout")`` the same named stream at every call, seeded from
the seed and ``_stable_hash`` of the name, which is bitwise the JAX
function. The numbers differ from jax.random's; the policy is the same.
"""
from __future__ import annotations

import torch


class PRNGSeq:
    """A stateful source of fresh generators on ``device``.

    >>> gens = PRNGSeq(42, device="cpu")
    >>> g1 = gens()           # a fresh stream
    >>> g2 = gens("dropout")  # the same stream for the same name, every time
    """

    def __init__(self, seed: int, device="cuda"):
        self._seed = int(seed)
        self._count = 0
        self.device = torch.device(device)

    def __call__(self, name: str | None = None) -> torch.Generator:
        if name is not None:
            return self._generator(_stable_hash(name))
        self._count += 1
        return self._generator(self._count)

    def _generator(self, salt: int) -> torch.Generator:
        # seed and salt side by side in one 64-bit seed: distinct pairs, distinct seeds
        seed = ((self._seed & 0xFFFFFFFF) << 32) | (salt & 0xFFFFFFFF)
        return torch.Generator(device=self.device).manual_seed(seed)


def _stable_hash(name: str) -> int:
    """31-bit FNV-1a of the UTF-8 bytes, as the JAX package folds names in."""
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return h


def uniform_like(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) f32 of x's shape, on x's device (the generator's)."""
    return torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
