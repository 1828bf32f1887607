"""Feature quantization (value -> integer bin).

The port's own copy of ``lightgbm_tpu/io/binning.py`` (reference
bin.h:61 ``BinMapper``; bin.cpp ``GreedyFindBin`` /
``FindBinWithZeroAsOneBin``): equal-count greedy boundaries with
``min_data_in_bin``, a protected zero bin, a trailing NaN bin under
``use_missing``, and categorical bins by descending frequency with bin 0
for unseen / NaN.  Boundaries are the JAX package's to the bit, so a
dataset bins identically in both packages.  ``MissingType`` /
``BinType`` carry the values the model text's ``decision_type`` bits
use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..utils import log

KZERO_THRESHOLD = 1e-35


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1


def _greedy_find_boundaries(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Equal-count greedy binning of sorted distinct values.

    Returns the list of bin upper bounds (midpoints between distinct values),
    with the final bound omitted (caller appends +inf).  Mirrors the behavior
    of GreedyFindBin (bin.cpp): values with large counts get dedicated bins;
    otherwise accumulate until the running mean bin size is reached.
    """
    nd = len(distinct_values)
    if nd == 0 or max_bin <= 1:
        return []
    bounds: List[float] = []
    if nd <= max_bin:
        cur = 0
        for i in range(nd - 1):
            cur += counts[i]
            if cur >= min_data_in_bin:
                bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                cur = 0
        return bounds

    max_bin = max(1, max_bin)
    mean_size = total_cnt / max_bin
    # values big enough to deserve their own bin
    is_big = counts >= mean_size
    rest_cnt = total_cnt - counts[is_big].sum()
    rest_bins = max_bin - int(is_big.sum())
    mean_rest = rest_cnt / max(rest_bins, 1)
    lower = max(min_data_in_bin, 1)

    cur = 0
    remaining_cnt = rest_cnt
    remaining_bins = max(rest_bins, 1)
    for i in range(nd - 1):
        if not is_big[i]:
            cur += counts[i]
        if is_big[i] or is_big[i + 1] or cur >= max(lower, mean_rest):
            if cur > 0 or is_big[i]:
                bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not is_big[i]:
                    remaining_cnt -= cur
                    remaining_bins = max(remaining_bins - 1, 1)
                    mean_rest = remaining_cnt / remaining_bins
                cur = 0
        if len(bounds) >= max_bin - 1:
            break
    return bounds


@dataclasses.dataclass
class BinMapper:
    """Per-feature value->bin mapping (reference: bin.h:61)."""

    bin_type: int = BinType.NUMERICAL
    missing_type: int = MissingType.NONE
    num_bins: int = 1
    # numerical: ascending upper bounds, len == num "value" bins (excludes the
    # appended NaN bin when missing_type == NAN); last entry is +inf
    upper_bounds: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([np.inf]))
    # categorical: sorted category values and their bins
    cat_values: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([], dtype=np.int64))
    cat_bins: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([], dtype=np.int32))
    default_bin: int = 0  # bin of value 0.0 (reference most_freq/default bin)

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    @property
    def has_nan_bin(self) -> bool:
        return (self.bin_type == BinType.NUMERICAL
                and self.missing_type == MissingType.NAN)

    @property
    def nan_bin(self) -> int:
        return self.num_bins - 1

    # ------------------------------------------------------------------
    @classmethod
    def find_bin(
        cls,
        sample_values: np.ndarray,
        total_sample_cnt: int,
        max_bin: int,
        min_data_in_bin: int = 3,
        *,
        bin_type: int = BinType.NUMERICAL,
        use_missing: bool = True,
        zero_as_missing: bool = False,
    ) -> "BinMapper":
        """Construct the mapping from sampled raw values.

        ``sample_values`` may contain NaN.  ``total_sample_cnt`` may exceed
        ``len(sample_values)`` — the difference is implicit zeros (the
        reference's sparse sampling passes only non-zero values,
        dataset_loader.cpp:1012).
        """
        sample_values = np.asarray(sample_values, dtype=np.float64)
        if bin_type == BinType.CATEGORICAL:
            return cls._find_bin_categorical(
                sample_values, max_bin, min_data_in_bin, use_missing)

        na_cnt = int(np.isnan(sample_values).sum())
        values = sample_values[~np.isnan(sample_values)]
        implicit_zeros = max(total_sample_cnt - len(sample_values), 0)

        if zero_as_missing:
            missing_type = MissingType.ZERO
        elif use_missing and na_cnt > 0:
            missing_type = MissingType.NAN
        else:
            missing_type = MissingType.NONE
            # NaNs present but use_missing off: reference treats them as zeros
            if na_cnt > 0:
                implicit_zeros += na_cnt
                na_cnt = 0

        neg = values[values < -KZERO_THRESHOLD]
        pos = values[values > KZERO_THRESHOLD]
        zero_cnt = len(values) - len(neg) - len(pos) + implicit_zeros

        n_value_bins = max_bin - (1 if missing_type == MissingType.NAN else 0)
        total = len(neg) + len(pos) + zero_cnt
        bounds: List[float] = []
        if total > 0 and n_value_bins >= 2:
            # budget split proportional to counts; zero always owns one bin
            n_avail = n_value_bins - (1 if zero_cnt > 0 else 0)
            neg_bins = int(round(n_avail * len(neg) / max(total, 1)))
            if len(neg) > 0:
                neg_bins = max(neg_bins, 1)
            pos_bins = n_avail - neg_bins
            if len(pos) > 0 and pos_bins < 1:
                pos_bins, neg_bins = 1, max(n_avail - 1, 0)

            if len(neg) > 0 and neg_bins > 0:
                dv, cnt = np.unique(neg, return_counts=True)
                bounds += _greedy_find_boundaries(
                    dv, cnt, neg_bins, len(neg), min_data_in_bin)
                bounds.append(-KZERO_THRESHOLD)
            if zero_cnt > 0 and (len(pos) > 0):
                bounds.append(KZERO_THRESHOLD)
            if len(pos) > 0 and pos_bins > 0:
                dv, cnt = np.unique(pos, return_counts=True)
                pb = _greedy_find_boundaries(
                    dv, cnt, pos_bins, len(pos), min_data_in_bin)
                bounds += pb
        bounds = sorted(set(bounds))
        upper = np.array(bounds + [np.inf], dtype=np.float64)
        num_bins = len(upper) + (1 if missing_type == MissingType.NAN else 0)
        if num_bins <= 1:
            missing_type = MissingType.NONE
        m = cls(
            bin_type=BinType.NUMERICAL,
            missing_type=missing_type,
            num_bins=int(num_bins),
            upper_bounds=upper,
        )
        m.default_bin = int(np.searchsorted(upper, 0.0, side="left"))
        return m

    @classmethod
    def _find_bin_categorical(
        cls, sample_values: np.ndarray, max_bin: int,
        min_data_in_bin: int, use_missing: bool,
    ) -> "BinMapper":
        vals = sample_values[~np.isnan(sample_values)]
        ivals = vals.astype(np.int64)
        if np.any(ivals < 0):
            log.warning("Met negative category value, converted to NaN/other bin")
            ivals = ivals[ivals >= 0]
        cats, counts = np.unique(ivals, return_counts=True)
        # drop ultra-rare categories into the 'other' bin (reference's
        # min_data_in_bin cut), but never filter everything away
        frequent = counts >= min_data_in_bin
        if frequent.any():
            cats, counts = cats[frequent], counts[frequent]
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        # keep at most max_bin-1 categories (bin 0 = other/NaN/unseen)
        keep = min(len(cats), max_bin - 1)
        cats, counts = cats[:keep], counts[:keep]
        nb = keep + 1
        cat_bins = np.arange(1, keep + 1, dtype=np.int32)
        sort_idx = np.argsort(cats)
        m = cls(
            bin_type=BinType.CATEGORICAL,
            missing_type=MissingType.NAN if use_missing else MissingType.NONE,
            num_bins=int(nb),
            cat_values=cats[sort_idx],
            cat_bins=cat_bins[sort_idx],
        )
        return m

    # ------------------------------------------------------------------
    def values_to_bins(self, x: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (reference bin.h:491 binary search)."""
        x = np.asarray(x, dtype=np.float64)
        if self.bin_type == BinType.CATEGORICAL:
            out = np.zeros(x.shape, dtype=np.int32)
            finite = np.isfinite(x)
            xi = np.where(finite, x, -1).astype(np.int64)
            pos = np.searchsorted(self.cat_values, xi)
            pos = np.clip(pos, 0, max(len(self.cat_values) - 1, 0))
            if len(self.cat_values):
                hit = finite & (self.cat_values[pos] == xi) & (xi >= 0)
                out[hit] = self.cat_bins[pos[hit]]
            return out
        isnan = np.isnan(x)
        if self.missing_type == MissingType.ZERO:
            x = np.where(isnan, 0.0, x)
        b = np.searchsorted(self.upper_bounds, x, side="left")
        b = np.clip(b, 0, len(self.upper_bounds) - 1)
        if self.missing_type == MissingType.NAN:
            b = np.where(isnan, self.nan_bin, b)
        return b.astype(np.int32)

    def bin_to_threshold(self, bin_idx: int) -> float:
        """Real-valued split threshold for 'go left if value <= threshold'
        (reference: Tree stores the bin upper bound as the model threshold)."""
        ub = self.upper_bounds
        i = min(int(bin_idx), len(ub) - 1)
        v = float(ub[i])
        if np.isinf(v):
            v = float(np.finfo(np.float64).max)
        return v

    # serialization (reference: BinMapper::CopyTo/CopyFrom for cross-machine
    # bin sync and binary dataset files)
    def to_dict(self) -> Dict:
        return {
            "bin_type": self.bin_type,
            "missing_type": self.missing_type,
            "num_bins": self.num_bins,
            "upper_bounds": self.upper_bounds.tolist(),
            "cat_values": self.cat_values.tolist(),
            "cat_bins": self.cat_bins.tolist(),
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "BinMapper":
        return cls(
            bin_type=int(d["bin_type"]),
            missing_type=int(d["missing_type"]),
            num_bins=int(d["num_bins"]),
            upper_bounds=np.asarray(d["upper_bounds"], dtype=np.float64),
            cat_values=np.asarray(d["cat_values"], dtype=np.int64),
            cat_bins=np.asarray(d["cat_bins"], dtype=np.int32),
            default_bin=int(d.get("default_bin", 0)),
        )
