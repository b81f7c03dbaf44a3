"""Integer seeds in place of ``jax.random`` keys.

torch cannot reproduce JAX's threefry bits, so the port passes plain
integer seeds: the engine folds the step index into its seed, and each
device of a vmapped step gets a seed of its own. A ``train_fn`` that needs
randomness seeds a generator from its key; the CNN's ignores it, like the
reference harness's.

A seed may also be an int64 tensor (a seed sweep hands each lane's seed to
the vmapped step as one): ``fold_in`` then computes the same splitmix64
bits in int64 arithmetic, which wraps modulo 2**64 like the masked Python
ints (the shifts are made logical by masking), and ``split`` adds the
device index to it.
"""
from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_SEED_BITS = (1 << 62) - 1      # room to add a device index without overflow


def _i64(c: int) -> int:
    """A 64-bit pattern as the int64 with the same bits."""
    c &= _M64
    return c - (1 << 64) if c >> 63 else c


def _shr(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _fold_in_tensor(seed: torch.Tensor, data: int) -> torch.Tensor:
    z = seed.to(torch.int64) * _i64(0x9E3779B97F4A7C15) + _i64(data + 1)
    z = (z ^ _shr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    return (z ^ _shr(z, 31)) & _SEED_BITS


def fold_in(seed, data: int):
    """A new seed from ``(seed, data)`` (splitmix64 finaliser); ``seed`` an
    int, or an int64 tensor of seeds (then a tensor of the same bits)."""
    if isinstance(seed, torch.Tensor):
        return _fold_in_tensor(seed, data)
    z = (seed * 0x9E3779B97F4A7C15 + data + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _SEED_BITS


def split(seed, n: int, device) -> torch.Tensor:
    """``n`` distinct per-device seeds, int64 on ``device`` (``seed`` an int
    or an int64 tensor of one seed)."""
    return torch.arange(n, dtype=torch.int64, device=device) + fold_in(seed, n)
