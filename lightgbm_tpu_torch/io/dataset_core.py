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
``dataset_core.py:217-225``) for the leaf models.

The other inputs are the JAX package's (``dataset_core.py:141-481``):
scipy CSR / CSC input is binned column by column from CSC without
densifying the float matrix (the zero bin filled, then the stored
entries quantized); row-access sequences stream in ``batch_size`` chunks
(:meth:`BinnedDataset.construct_from_sequences`); :meth:`subset` takes
rows sharing the mappers; the binary cache (:meth:`save_binary`,
:meth:`load_binary`) is the JAX package's npz layout key for key, so a
cache written by either package loads in the other.  EFB bundling is not
ported (``ROADMAP.md`` A5).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

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
        sparse = is_scipy_sparse(data)
        if sparse:
            n, num_total = data.shape
        else:
            data = np.asarray(data)
            if data.ndim == 1:
                data = data.reshape(-1, 1)
            if data.ndim != 2:
                log.fatal("Data must be 2-dimensional, got %d dims",
                          data.ndim)
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
            self._take_reference(reference)
        else:
            sample_cnt = min(config.bin_construct_sample_cnt, n)
            sidx = sample_indices(n, sample_cnt, config.data_random_seed)
            # sparse: the sampled rows in CSR, then CSC for the columns
            sample = (SparseColumnView(data.tocsr()[sidx].tocsc())
                      if sparse else data[sidx])
            self._find_mappers(sample, num_total, sample_cnt, config,
                               categorical_indices)
        dtype = self._bin_dtype()
        mat = np.empty((n, len(self.mappers)), dtype=dtype)
        if sparse:
            # each column the zero bin, then its stored entries quantized
            csc = data.tocsc()
            for j, (orig, m) in enumerate(zip(self.used_feature_map,
                                              self.mappers)):
                mat[:, j] = m.values_to_bins(np.zeros(1))[0]
                lo, hi = csc.indptr[orig], csc.indptr[orig + 1]
                if hi > lo:
                    mat[csc.indices[lo:hi], j] = m.values_to_bins(
                        np.asarray(csc.data[lo:hi], np.float64)).astype(dtype)
        else:
            for j, (orig, m) in enumerate(zip(self.used_feature_map,
                                              self.mappers)):
                mat[:, j] = m.values_to_bins(data[:, orig]).astype(dtype)
        self.bin_matrix = mat
        if config.linear_tree and self.mappers:
            if sparse:
                view = SparseColumnView(csc)
                self.raw_matrix = np.stack(
                    [view[:, int(o)] for o in self.used_feature_map],
                    axis=1).astype(np.float32)
            else:
                self.raw_matrix = np.ascontiguousarray(
                    data[:, self.used_feature_map], dtype=np.float32)
        self._set_metadata(n, label, weight, group, init_score)
        return self

    def _bin_dtype(self):
        return (np.uint16 if any(m.num_bins > 256 for m in self.mappers)
                else np.uint8)

    def _set_metadata(self, n: int, label, weight, group, init_score
                      ) -> None:
        self.metadata.num_data = n
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        self.metadata.check(n)

    def _take_reference(self, reference: "BinnedDataset") -> None:
        self.mappers = reference.mappers
        self.used_feature_map = reference.used_feature_map
        self.num_total_features = reference.num_total_features
        self.feature_names = reference.feature_names

    @classmethod
    def construct_from_sequences(
        cls,
        seqs: List,
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
        """Bin row-access sequences (``len`` and ``seq[i]`` / ``seq[a:b]``)
        in two passes, as the JAX package does
        (``dataset_core.py:312-405``): the bin-finding sample read row by
        row, then every sequence quantized in ``batch_size`` chunks into
        the bin matrix, so the whole float matrix never exists.  The
        mappers and bins are the dense matrix's."""
        lens = [len(s) for s in seqs]
        n = int(sum(lens))
        if n == 0:
            log.fatal("Sequences contain no rows")
        first_seq = next(s for s, m in zip(seqs, lens) if m > 0)
        num_total = np.atleast_2d(np.asarray(first_seq[0:1],
                                             dtype=np.float64)).shape[1]
        self = cls()
        self.num_total_features = num_total
        self.feature_names = (list(feature_names) if feature_names is not None
                              else [f"Column_{i}" for i in range(num_total)])
        offsets = np.concatenate([[0], np.cumsum(lens)])
        if reference is not None:
            self._take_reference(reference)
        else:
            sample_cnt = min(config.bin_construct_sample_cnt, n)
            sidx = sample_indices(n, sample_cnt, config.data_random_seed)
            sample = np.empty((sample_cnt, num_total), dtype=np.float64)
            for i, gi in enumerate(sidx):
                s = int(np.searchsorted(offsets, gi, side="right")) - 1
                sample[i] = np.asarray(seqs[s][int(gi - offsets[s])],
                                       dtype=np.float64)
            self._find_mappers(sample, num_total, sample_cnt, config,
                               categorical_indices)
        dtype = self._bin_dtype()
        mat = np.empty((n, len(self.mappers)), dtype=dtype)
        raw = (np.empty((n, len(self.mappers)), np.float32)
               if config.linear_tree and self.mappers else None)
        row0 = 0
        for s in seqs:
            bs = int(getattr(s, "batch_size", 0) or 4096)
            for start in range(0, len(s), bs):
                chunk = np.atleast_2d(np.asarray(s[start:start + bs],
                                                 dtype=np.float64))
                rows = slice(row0, row0 + len(chunk))
                for j, (orig, m) in enumerate(zip(self.used_feature_map,
                                                  self.mappers)):
                    mat[rows, j] = m.values_to_bins(
                        chunk[:, orig]).astype(dtype)
                if raw is not None:
                    raw[rows] = chunk[:, self.used_feature_map]
                row0 += len(chunk)
        if row0 != n:
            log.fatal("Sequences gave %d rows, their lengths %d", row0, n)
        self.bin_matrix = mat
        self.raw_matrix = raw
        self._set_metadata(n, label, weight, group, init_score)
        return self

    def subset(self, indices) -> "BinnedDataset":
        """The rows ``indices`` sharing the mappers (reference
        Dataset::CopySubrow): their bins, raw values, labels, weights and
        each class's init scores; a ranked dataset loses its query
        info, with the JAX package's warning."""
        indices = np.asarray(indices)
        out = BinnedDataset()
        out._take_reference(self)
        out.bin_matrix = self.bin_matrix[indices]
        if self.raw_matrix is not None:
            out.raw_matrix = self.raw_matrix[indices]
        md, omd = self.metadata, out.metadata
        omd.num_data = len(indices)
        if md.label is not None:
            omd.label = md.label[indices]
        if md.weight is not None:
            omd.weight = md.weight[indices]
        if md.init_score is not None:
            k = len(md.init_score) // md.num_data
            omd.init_score = md.init_score.reshape(
                k, md.num_data)[:, indices].reshape(-1)
        if md.query_boundaries is not None:
            log.warning("Row subset of a ranked dataset drops query info")
        return out

    # -- the binary cache (reference save_binary / LoadFromBinFile) ------
    def save_binary(self, path: str) -> None:
        """The JAX package's cache: a compressed npz at exactly ``path``
        holding ``bin_matrix``, ``used_feature_map``, ``meta_json`` (the
        feature count, names and each mapper's ``to_dict``), the raw
        matrix if kept and each metadata array present."""
        meta: Dict[str, Any] = {
            "num_total_features": self.num_total_features,
            "feature_names": self.feature_names,
            "mappers": [m.to_dict() for m in self.mappers],
        }
        arrays: Dict[str, np.ndarray] = {
            "bin_matrix": self.bin_matrix,
            "used_feature_map": self.used_feature_map,
            "meta_json": np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8),
        }
        if self.raw_matrix is not None:
            arrays["raw_matrix"] = self.raw_matrix
        md = self.metadata
        for name in ("label", "weight", "init_score", "query_boundaries"):
            v = getattr(md, name)
            if v is not None:
                arrays[name] = v
        # np.savez appends .npz: write there, then move to the exact path
        tmp = path if path.endswith(".npz") else path + ".npz"
        np.savez_compressed(tmp, **arrays)
        if tmp != path:
            os.replace(tmp, path)
        log.info("Saved binary dataset to %s", path)

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        with open(path, "rb") as fh:
            z = dict(np.load(fh, allow_pickle=False))
        self = cls()
        meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
        self.num_total_features = meta["num_total_features"]
        self.feature_names = meta["feature_names"]
        self.mappers = [BinMapper.from_dict(d) for d in meta["mappers"]]
        self.bin_matrix = z["bin_matrix"]
        self.used_feature_map = z["used_feature_map"]
        self.raw_matrix = z.get("raw_matrix")
        md = self.metadata
        md.num_data = self.bin_matrix.shape[0]
        for name in ("label", "weight", "init_score", "query_boundaries"):
            if name in z:
                setattr(md, name, z[name])
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


def is_scipy_sparse(data) -> bool:
    return (hasattr(data, "tocsc") and hasattr(data, "tocsr")
            and not isinstance(data, np.ndarray))


class SparseColumnView:
    """``view[:, j]``: column ``j`` of a CSC matrix as a dense f64 array
    (bin finding reads one column at a time, so the whole matrix is
    never densified)."""

    def __init__(self, csc):
        self._csc = csc

    def __getitem__(self, key):
        _, j = key
        col = np.zeros(self._csc.shape[0], dtype=np.float64)
        lo, hi = self._csc.indptr[j], self._csc.indptr[j + 1]
        col[self._csc.indices[lo:hi]] = self._csc.data[lo:hi]
        return col
