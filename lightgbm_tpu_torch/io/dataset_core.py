"""Binned dataset and metadata (host side, numpy).

The port's own copy of the dense-input core of
``lightgbm_tpu/io/dataset_core.py`` (reference dataset.h:45
``Metadata``, dataset.h:425 ``Dataset``): bin mappers are found on a
seeded row sample exactly as the JAX package finds them, trivial
(single-bin) features are dropped under ``feature_pre_filter``, and the
quantized matrix is one dense ``[rows, used_features]`` uint8 matrix.
Query groups are kept as boundaries (``Metadata.set_group``).  With
``linear_tree`` the raw values of the used features are kept too
(``raw_matrix`` ``[rows, used_features]`` f32, JAX
``dataset_core.py:217-225``) for the leaf models.  Scipy
sparse input, streaming sequences, EFB bundling and the binary cache
are not ported (``ROADMAP.md`` A5).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from .binning import BinMapper, BinType


def sample_indices(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` distinct sorted indices out of ``n``, deterministic in
    ``seed`` (the JAX package's ``utils.random.sample_indices``)."""
    rng = np.random.Generator(np.random.PCG64(seed & 0xFFFFFFFF))
    if k >= n:
        return np.arange(n, dtype=np.int64)
    idx = rng.choice(n, size=k, replace=False)
    idx.sort()
    return idx


@dataclasses.dataclass
class Metadata:
    """Per-row training metadata (reference: dataset.h:45)."""

    label: Optional[np.ndarray] = None          # float32 [n]
    weight: Optional[np.ndarray] = None         # float32 [n]
    init_score: Optional[np.ndarray] = None     # float64 [n * num_class]
    query_boundaries: Optional[np.ndarray] = None   # int32 [Q + 1]
    num_data: int = 0

    def set_label(self, label) -> None:
        self.label = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)

    def set_weight(self, weight) -> None:
        self.weight = (None if weight is None else np.ascontiguousarray(
            weight, dtype=np.float32).reshape(-1))

    def set_init_score(self, init_score) -> None:
        self.init_score = (None if init_score is None
                           else np.ascontiguousarray(
                               init_score, dtype=np.float64).reshape(-1))

    def set_group(self, group) -> None:
        """Per-query sizes (the reference's query file) stored as
        cumulative boundaries (dataset.h:222).  An array that already
        reads as boundaries (non-decreasing, ending at ``num_data``) is
        taken as such, with a leading 0 added where it lacks one."""
        if group is None:
            self.query_boundaries = None
            return
        g = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        if (len(g) and g[-1] == self.num_data and np.all(np.diff(g) >= 0)
                and g[0] != self.num_data):
            bounds = np.concatenate([[0], g]) if g[0] != 0 else g
        else:
            bounds = np.concatenate([[0], np.cumsum(g)])
        if self.num_data and bounds[-1] != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)",
                      bounds[-1], self.num_data)
        self.query_boundaries = bounds.astype(np.int32)

    def check(self, num_data: int) -> None:
        self.num_data = num_data
        qb = self.query_boundaries
        if qb is not None and qb[-1] != num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)",
                      qb[-1], num_data)
        if self.label is not None and len(self.label) != num_data:
            log.fatal("Length of label (%d) != num_data (%d)",
                      len(self.label), num_data)
        if self.weight is not None and len(self.weight) != num_data:
            log.fatal("Length of weight (%d) != num_data (%d)",
                      len(self.weight), num_data)


class BinnedDataset:
    """The quantized training matrix and its per-feature mappers.

    ``bin_matrix`` is ``[num_data, num_used_features]`` uint8 (uint16
    when a feature has more than 256 bins); ``mappers[j]`` quantizes
    original feature ``used_feature_map[j]``; ``raw_matrix`` holds the
    same columns' raw values (f32) under ``linear_tree``, else None.
    """

    def __init__(self) -> None:
        self.bin_matrix: Optional[np.ndarray] = None
        self.raw_matrix: Optional[np.ndarray] = None
        self.mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = np.array([], dtype=np.int32)
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.metadata = Metadata()

    @property
    def num_data(self) -> int:
        return 0 if self.bin_matrix is None else self.bin_matrix.shape[0]

    @property
    def num_features(self) -> int:
        return 0 if self.bin_matrix is None else self.bin_matrix.shape[1]

    @property
    def num_bins_per_feature(self) -> np.ndarray:
        return np.array([m.num_bins for m in self.mappers], dtype=np.int32)

    @classmethod
    def construct(
        cls,
        data: np.ndarray,
        config: Config,
        *,
        label=None,
        weight=None,
        group=None,
        init_score=None,
        feature_names: Optional[Sequence[str]] = None,
        categorical_indices: Optional[Sequence[int]] = None,
        reference: Optional["BinnedDataset"] = None,
    ) -> "BinnedDataset":
        """Bin a dense ``[n, F]`` matrix.  With ``reference`` the
        reference's mappers are reused (validation sets must bin
        identically to the training set)."""
        if hasattr(data, "tocsc") and not isinstance(data, np.ndarray):
            log.fatal("scipy sparse input is not ported to "
                      "lightgbm_tpu_torch yet (see ROADMAP.md A5); pass "
                      "a dense array")
        data = np.asarray(data)
        if data.ndim == 1:
            data = data.reshape(-1, 1)
        if data.ndim != 2:
            log.fatal("Data must be 2-dimensional, got %d dims", data.ndim)
        data = np.ascontiguousarray(data, dtype=np.float64)
        n, num_total = data.shape
        self = cls()
        self.num_total_features = num_total
        self.feature_names = (list(feature_names) if feature_names is not None
                              else [f"Column_{i}" for i in range(num_total)])
        if len(self.feature_names) != num_total:
            log.fatal("feature_names length mismatch")
        if reference is not None:
            if num_total != reference.num_total_features:
                log.fatal("The number of features in data (%d) does not "
                          "match the reference dataset (%d)", num_total,
                          reference.num_total_features)
            self.mappers = reference.mappers
            self.used_feature_map = reference.used_feature_map
            self.feature_names = reference.feature_names
        else:
            sample_cnt = min(config.bin_construct_sample_cnt, n)
            sidx = sample_indices(n, sample_cnt, config.data_random_seed)
            self._find_mappers(data[sidx], num_total, sample_cnt, config,
                               categorical_indices)
        dtype = (np.uint16 if any(m.num_bins > 256 for m in self.mappers)
                 else np.uint8)
        mat = np.empty((n, len(self.mappers)), dtype=dtype)
        for j, (orig, m) in enumerate(zip(self.used_feature_map,
                                          self.mappers)):
            mat[:, j] = m.values_to_bins(data[:, orig]).astype(dtype)
        self.bin_matrix = mat
        if config.linear_tree and self.mappers:
            self.raw_matrix = np.ascontiguousarray(
                data[:, self.used_feature_map], dtype=np.float32)
        self.metadata.num_data = n
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        self.metadata.check(n)
        return self

    def _find_mappers(self, sample, num_total: int, sample_cnt: int,
                      config: Config, categorical_indices) -> None:
        """Per-feature bin finding over the sampled rows
        (dataset_loader.cpp:1012)."""
        cat_set = set(categorical_indices or [])
        mb_by_feature = config.max_bin_by_feature
        mappers: List[BinMapper] = []
        used: List[int] = []
        for j in range(num_total):
            mb = (mb_by_feature[j] if j < len(mb_by_feature)
                  else config.max_bin)
            m = BinMapper.find_bin(
                sample[:, j], total_sample_cnt=sample_cnt, max_bin=mb,
                min_data_in_bin=config.min_data_in_bin,
                bin_type=(BinType.CATEGORICAL if j in cat_set
                          else BinType.NUMERICAL),
                use_missing=config.use_missing,
                zero_as_missing=config.zero_as_missing)
            if m.is_trivial and config.feature_pre_filter:
                continue   # a single-bin feature can never split
            mappers.append(m)
            used.append(j)
        self.mappers = mappers
        self.used_feature_map = np.array(used, dtype=np.int32)
        if not used:
            log.warning("There are no meaningful features which satisfy "
                        "the provided configuration.")
