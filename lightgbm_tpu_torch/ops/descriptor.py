"""The split descriptor that the partitions and the fused split read:
its slots, in the layout of the JAX package's
``ops/pallas/partition_kernel.py``, and its membership words, with the
conversions between member bins and words that the grower, the
kernels' wrappers and the tree share.

A descriptor is ``SEL_MEMBER`` integer slots (seven used, an eighth
spare), then, on the sorted-subset routes, up to
:data:`MAX_MEMBER_WORDS` membership words: bit ``b % 32`` of word
``b // 32`` is set for a bin ``b`` that goes left.  The kernels hold the
same bound (``csrc/partition_common.cuh`` ``kMaxWords``); a wider
bitset is the ``cat_overwide`` route's (``routing.cat_bitset_fit``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

SEL_S0, SEL_CNT, SEL_FEAT, SEL_SBIN, SEL_DL, SEL_CAT, SEL_NANB = range(7)
SEL_MEMBER = 8
# membership words a descriptor may carry (the JAX package's
# layout.CAT_BITSET_WORDS): 256 bins
MAX_MEMBER_WORDS = 8


def members_to_words(members: torch.Tensor) -> torch.Tensor:
    """``[ni, B]`` bool (or 0/1) membership -> ``[ni, ceil(B / 32)]`` i32
    words, bit ``b % 32`` of word ``b // 32`` set for a member bin ``b``
    (the JAX package's ``ops/predict._members_to_words``); a word with
    bit 31 set is its u32 bits read as i32.  On the members' device."""
    ni, b = members.shape
    w = -(-b // 32)
    m = members.to(torch.int64)
    if w * 32 != b:
        m = torch.nn.functional.pad(m, (0, w * 32 - b))
    shifts = torch.arange(32, dtype=torch.int64, device=members.device)
    words = (m.reshape(ni, w, 32) << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def words_to_members(words: Sequence[int], n_bins: int) -> np.ndarray:
    """Host membership words (i32 or u32) -> bool ``[n_bins]``: bit
    ``b % 32`` of word ``b // 32`` (bins past the last word false)."""
    bins = np.arange(n_bins)
    w = np.array(list(words) + [0], np.int64) & 0xFFFFFFFF
    return (w[np.minimum(bins >> 5, len(words))] >> (bins & 31)) & 1 > 0


def member_words(sel: Sequence[int]) -> list:
    """The descriptor's membership words as u32 values (empty without
    them); i32 words with bit 31 set are read as their u32 bits."""
    return [int(w) & 0xFFFFFFFF for w in sel[SEL_MEMBER:]]

