"""Deterministic random streams (counterpart of
``lightgbm_tpu/utils/random.py`` and of the ``jax.random`` calls that
module defers to).

Host-side sampling (feature masks) draws from a numpy PCG64 generator,
:func:`make_rng`.  Per-row draws on the device (the bagging mask, GOSS's
sample of the small-gradient rows) reproduce ``jax.random.uniform`` on a
``jax.random.PRNGKey`` bit for bit: the threefry2x32 block cipher (20
rounds, Salmon et al. 2011, as JAX implements it) in its
*partitionable* form, where row ``i``'s 32 random bits are
``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``, so a
row's draw depends only on the key and the row.  Every step is an
integer operation on int64 tensors masked to 32 bits, so the card and
the CPU give the same bits.

A key is a pair of 32-bit words, Python ints or int64 tensors that
broadcast: :func:`fold_in` over a tensor of salts gives a tensor of
keys, and :func:`uniform_rows` draws one ``jax.random.uniform(key,
(n,))`` row for each of them in one call (the split search's per-node
draws, a tree's nodes at once).
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the f32 exponent of 1.0: 23 random mantissa bits under it give a
# float in [1, 2)
_ONE_BITS = 0x3F800000

Word = Union[int, torch.Tensor]


def make_rng(seed: int) -> np.random.Generator:
    """numpy's PCG64 generator on the seed's low 32 bits."""
    return np.random.Generator(np.random.PCG64(seed & _M32))


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two 32-bit words: the seed's
    high and low words (``(0, seed)`` for ``0 <= seed < 2**32``)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"prng_key takes a non-negative seed, got {seed}")
    return (seed >> 32) & _M32, seed & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Tuple[Word, Word], hi: torch.Tensor,
                 lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter words ``(hi, lo)`` (int64 tensors of
    values below 2**32) under ``key``, whose words are ints or int64
    tensors that broadcast against the counters; the two 32-bit output
    words as int64 tensors."""
    k0, k1 = (w & _M32 if isinstance(w, torch.Tensor) else int(w) & _M32
              for w in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (hi + ks[0]) & _M32
    x1 = (lo + ks[1]) & _M32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def fold_in(key: Tuple[Word, Word], data: Word, device=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)``: threefry2x32 of the counter
    ``(0, data)`` under ``key`` (``data`` taken as uint32).  ``data`` an
    int or an int64 tensor of salts; the words of the new key (or of
    one key a salt) as int64 tensors on ``device`` (the tensors'
    own where one is given)."""
    if not isinstance(data, torch.Tensor):
        dev = next((w.device for w in key if isinstance(w, torch.Tensor)),
                   device)
        data = torch.tensor(int(data), dtype=torch.int64, device=dev)
    lo = data.to(torch.int64) & _M32
    return threefry2x32(key, torch.zeros_like(lo), lo)


def random_bits(key: Tuple[int, int], n: int,
                device: torch.device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` under the partitionable
    threefry: int64 [n] of values below 2**32."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, i >> 32, i & _M32)
    return x0 ^ x1


def uniform(key: Tuple[int, int], n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: f32 [n] in [0, 1), the top 23
    bits of each row's random word as the mantissa of a float in
    [1, 2), less 1."""
    bits = (random_bits(key, n, torch.device(device)) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_rows(key: Tuple[Word, Word], n: int, device) -> torch.Tensor:
    """``jax.random.uniform(k, (n,))`` for each key ``k`` of ``key``,
    whose words are int64 tensors of shape ``[S]`` (or ints): f32
    ``[S, n]`` (``[n]`` for one key), each row the bits
    :func:`uniform` draws for its key, in one batched threefry."""
    dev = torch.device(device)
    k0, k1 = (w[:, None] if isinstance(w, torch.Tensor) and w.dim() == 1
              else w for w in key)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    x0, x1 = threefry2x32((k0, k1), i >> 32, i & _M32)
    bits = ((x0 ^ x1) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0
