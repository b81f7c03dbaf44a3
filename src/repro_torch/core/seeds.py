"""Integer seeds in place of ``jax.random`` keys.

torch cannot reproduce JAX's threefry bits, so the port passes plain
integer seeds: the engine folds the step index into its seed, and each
device of a vmapped step gets a seed of its own. A ``train_fn`` that needs
randomness seeds a generator from its key; the CNN's ignores it, like the
reference harness's.
"""
from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_SEED_BITS = (1 << 62) - 1      # room to add a device index without overflow


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``(seed, data)`` (splitmix64 finaliser)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _SEED_BITS


def split(seed: int, n: int, device) -> torch.Tensor:
    """``n`` distinct per-device seeds, int64 on ``device``."""
    return torch.arange(n, dtype=torch.int64, device=device) + fold_in(seed, n)
