"""The dataset inputs of the PyTorch port against the JAX package, on the
CPU: text files, the binary cache, scipy sparse, ``Sequence`` and the
``Dataset`` methods.

- ``io/loader.load_text_file`` (numpy only) against the JAX
  ``load_text_file`` (its native parser, built here) on CSV, TSV and
  LibSVM files with and without a header, the label, weight, group and
  ignore specs (by index and by ``name:``) and the side files: features,
  label, weight and group equal, NaNs as equal; ``Dataset(path)`` bins
  as the JAX ``Dataset(path)``.
- The binary cache both ways: a cache written by either package loads
  in the other with equal bins, mappers, names, raw values and metadata.
- ``subset``, ``add_features_from``, ``create_valid`` and the setters
  and getters against the JAX ``Dataset``.
- scipy CSR / CSC bins equal the dense matrix's and the JAX package's
  (binned without densifying: ``toarray`` is never called); a
  ``Sequence`` or a list of them bins as the dense matrix and as the
  JAX ``construct_from_sequences``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import loader as t_loader
from lightgbm_tpu_torch.io.dataset_core import BinnedDataset as TBinned
from test_torch_api import _jax
from test_torch_train import _data

torch.set_num_threads(1)

N = 300


def _problem(seed=0, n=N, f=5, nan=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random(x.shape) < nan] = np.nan
    y = (rng.random(n) > 0.5).astype(np.float64)
    q = np.repeat(np.arange(n // 10), 10)
    return x, y, q, rng


def _tok(v, miss):
    return miss if np.isnan(v) else repr(float(v))


def _write(path, rows, header=None):
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        f.write("\n".join(rows) + "\n")


def _csv(d):
    x, y, q, rng = _problem(1)
    _write(d / "plain.csv", [",".join([_tok(y[i], "")] + [_tok(v, "")
                                                          for v in x[i]])
                             for i in range(N)])
    np.savetxt(d / "plain.csv.weight", rng.random(N))
    return "plain.csv", {}


def _tsv(d):
    x, y, _, _ = _problem(2)
    _write(d / "plain.tsv", ["\t".join([_tok(y[i], "NA")]
                                       + [_tok(v, "nan") for v in x[i]])
                             for i in range(N)])
    return "plain.tsv", {}


def _csv_header_specs(d):
    x, y, q, rng = _problem(3)
    w = rng.random(N)
    _write(d / "named.csv",
           [",".join([_tok(v, "null") for v in x[i]]
                     + [repr(w[i]), _tok(y[i], ""), str(q[i])])
            for i in range(N)], header="f0,f1,f2,f3,f4,wt,target,qid")
    return "named.csv", {"header": True, "label_column": "name:target",
                         "weight_column": "name:wt",
                         "group_column": "name:qid", "ignore_column": "1,3"}


def _csv_index_specs(d):
    x, y, q, _ = _problem(4)
    _write(d / "index.csv",
           [",".join([str(q[i])] + [_tok(v, "N/A") for v in x[i]]
                     + [_tok(y[i], "")]) for i in range(N)],
           header="qid,a,b,c,d,e,y")
    return "index.csv", {"header": True, "label_column": "6",
                         "group_column": "0"}


def _libsvm(d):
    x, y, _, rng = _problem(5)
    x[rng.random(x.shape) < 0.4] = 0.0
    rows = [" ".join([repr(y[i])] + [f"{j}:{x[i, j]!r}" for j in range(5)
                                     if x[i, j] != 0.0])
            for i in range(N)]
    rows.insert(7, "# a comment line")
    _write(d / "data.svm", rows)
    np.savetxt(d / "data.svm.weight", rng.random(N))
    np.savetxt(d / "data.svm.query", np.full(N // 10, 10), fmt="%d")
    return "data.svm", {}


def _libsvm_group_file(d):
    x, y, _, rng = _problem(6)
    _write(d / "g.svm", [" ".join([repr(y[i])] + [f"{j + 1}:{x[i, j]!r}"
                                                  for j in range(5)
                                                  if np.isfinite(x[i, j])])
                         for i in range(N)])
    np.savetxt(d / "g.svm.group", np.full(N // 20, 20), fmt="%d")
    return "g.svm", {}


FILES = {"csv": _csv, "tsv": _tsv, "csv_header_names": _csv_header_specs,
         "csv_header_indices": _csv_index_specs, "libsvm": _libsvm,
         "libsvm_group_file": _libsvm_group_file}


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(FILES))
def test_loader_matches_jax(name, tmp_path):
    fname, params = FILES[name](tmp_path)
    path = str(tmp_path / fname)
    got = t_loader.load_text_file(path, TConfig.from_params(params))

    def jax_load(lgb):
        from lightgbm_tpu.config import Config as JConfig
        from lightgbm_tpu.io.loader import load_text_file
        return load_text_file(path, JConfig.from_params(params))
    want = _jax(jax_load)
    for a, b in zip(got, want):
        _equal(a, b)
    # and a Dataset of the file bins as the JAX package's
    ds = lgt.Dataset(path, params=dict(params, min_data_in_bin=1)).construct()
    jb = _jax(lambda lgb: lgb.Dataset(path, params=dict(
        params, min_data_in_bin=1)).construct()._binned)
    _equal(ds._binned.bin_matrix, jb.bin_matrix)
    md, jmd = ds._binned.metadata, jb.metadata
    for key in ("label", "weight", "query_boundaries"):
        _equal(getattr(md, key), getattr(jmd, key))


def test_load_init_score_file(tmp_path):
    path = str(tmp_path / "d.csv")
    assert t_loader.load_init_score_file(path) is None
    np.savetxt(path + ".init", np.arange(6) * 0.25)
    np.testing.assert_array_equal(t_loader.load_init_score_file(path),
                                  np.arange(6) * 0.25)


# -- the binary cache ----------------------------------------------------------
def _rich_arrays(seed=7):
    x, y, q, rng = _problem(seed, n=400, f=6)
    x[:, 4] = rng.integers(0, 5, 400)       # categorical
    x[:, 5] = 1.0                           # trivial: dropped
    return x, y, q, rng.random(400), rng.normal(size=400)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_binary_cache_both_ways(direction, tmp_path):
    x, y, q, w, init = _rich_arrays()
    params = {"linear_tree": True, "max_bin": 31}
    kw = dict(label=y, weight=w, group=np.full(40, 10), init_score=init,
              categorical_feature=[4], params=params)
    path = str(tmp_path / "cache.bin")
    if direction == "port_to_jax":
        src = lgt.Dataset(x, **kw).save_binary(path)._binned
        dst = _jax(lambda lgb: lgb.Dataset(path).construct()._binned)
    else:
        src = _jax(lambda lgb: lgb.Dataset(x, **kw).save_binary(path)
                   .construct()._binned)
        dst = lgt.Dataset(path).construct()._binned
    assert sorted(np.load(path).files) == [
        "bin_matrix", "init_score", "label", "meta_json", "query_boundaries",
        "raw_matrix", "used_feature_map", "weight"]
    assert dst.feature_names == src.feature_names
    assert dst.num_total_features == src.num_total_features == 6
    assert [m.to_dict() for m in dst.mappers] == \
        [m.to_dict() for m in src.mappers]
    for key in ("bin_matrix", "raw_matrix", "used_feature_map"):
        _equal(getattr(dst, key), getattr(src, key))
    for key in ("label", "weight", "init_score", "query_boundaries"):
        _equal(getattr(dst.metadata, key), getattr(src.metadata, key))
    assert dst.metadata.num_data == 400


def test_cached_dataset_trains_the_same_trees(tmp_path):
    x, y = _data(1500, 5, 3)
    path = str(tmp_path / "c.npz")
    lgt.Dataset(x, label=y).save_binary(path)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    a = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=2,
                  device="cpu")
    b = lgt.train(p, lgt.Dataset(path), num_boost_round=2, device="cpu")
    assert a.model_to_string() == b.model_to_string()


# -- the Dataset methods ---------------------------------------------------------
def _methods_pair(method):
    x, y, q, w, init = _rich_arrays(9)
    idx = np.random.default_rng(1).choice(400, 150, replace=False)
    x2 = np.random.default_rng(2).normal(size=(400, 3))

    def run(pkg):
        ds = pkg.Dataset(x, label=y, weight=w, init_score=init,
                         params={"max_bin": 31})
        if method == "subset":
            return ds.subset(idx).construct()
        if method == "add_features_from":
            return ds.add_features_from(pkg.Dataset(x2, label=y))
        if method == "create_valid":
            return ds.construct().create_valid(x[::3], label=y[::3]) \
                .construct()
        if method == "setters":
            ds.construct()
            ds.set_label(1 - y).set_weight(w * 2).set_init_score(init + 1)
            ds.set_group(np.full(40, 10))
            return ds
        return ds    # the getters before construction
    return run(lgt), _jax(run)


@pytest.mark.parametrize("method", ["subset", "add_features_from",
                                    "create_valid", "setters", "getters"])
def test_dataset_method_matches_jax(method):
    t, j = _methods_pair(method)
    if method == "getters":
        for g in ("get_label", "get_weight", "get_init_score", "get_group"):
            _equal(getattr(t, g)(), getattr(j, g)())
        assert t.get_feature_name() == j.get_feature_name()
        return
    tb, jb = t._binned, j._binned
    _equal(tb.bin_matrix, jb.bin_matrix)
    _equal(tb.used_feature_map, jb.used_feature_map)
    assert tb.feature_names == jb.feature_names
    assert tb.num_total_features == jb.num_total_features
    for g in ("get_label", "get_weight", "get_group"):
        _equal(getattr(t, g)(), getattr(j, g)())
    for key in ("init_score", "query_boundaries"):
        _equal(getattr(tb.metadata, key), getattr(jb.metadata, key))
    if method == "subset":
        assert t.num_data() == 150 and t.used_indices is not None
    if method == "add_features_from":
        assert t.num_feature() == 9


def test_add_features_from_keeps_raw_values_aligned():
    """Under ``linear_tree`` the appended features' raw values come
    along (the JAX package keeps only the first dataset's, ROADMAP C);
    without raw values on one side there are none."""
    x, y, *_ = _rich_arrays(10)
    x2 = np.random.default_rng(3).normal(size=(400, 2))
    p = {"linear_tree": True}
    a = lgt.Dataset(x, label=y, params=p).add_features_from(
        lgt.Dataset(x2, label=y, params=p))._binned
    assert a.raw_matrix.shape == a.bin_matrix.shape == (400, 7)
    np.testing.assert_array_equal(a.raw_matrix[:, 5:],
                                  x2.astype(np.float32))
    b = lgt.Dataset(x, label=y, params=p).add_features_from(
        lgt.Dataset(x2, label=y))._binned
    assert b.raw_matrix is None and b.bin_matrix.shape == (400, 7)


def test_subset_of_a_ranked_dataset_drops_queries():
    x, y, q, *_ = _rich_arrays()
    ds = lgt.Dataset(x, label=y, group=np.full(40, 10)).construct()
    sub = ds.subset(np.arange(50))
    assert sub._binned.metadata.query_boundaries is None
    assert ds._binned.metadata.query_boundaries is not None


# -- scipy sparse and Sequence -----------------------------------------------------
class _NoDense(sp.csr_matrix):
    def toarray(self, *a, **k):
        raise AssertionError("the sparse input was densified")

    todense = toarray


def _sparse_problem(seed=11, n=400, f=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random(x.shape) > 0.3] = 0.0
    x[rng.random(x.shape) < 0.02] = np.nan
    return x, (x[:, 0] + x[:, 1] > 0).astype(np.float32)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_bins_match_dense_and_jax(fmt):
    x, y = _sparse_problem()
    xs = sp.csr_matrix(x) if fmt == "csr" else sp.csc_matrix(x)
    cfg = TConfig.from_params({"max_bin": 63, "min_data_in_bin": 1,
                               "linear_tree": True})
    dense = TBinned.construct(x, cfg, label=y)
    sparse = TBinned.construct(_NoDense(xs) if fmt == "csr" else xs, cfg,
                               label=y)
    _equal(sparse.bin_matrix, dense.bin_matrix)
    _equal(sparse.raw_matrix, dense.raw_matrix)

    def jax_bins(lgb):
        from lightgbm_tpu.config import Config as JConfig
        from lightgbm_tpu.io.dataset_core import BinnedDataset
        return BinnedDataset.construct(xs, JConfig.from_params(
            {"max_bin": 63, "min_data_in_bin": 1}), label=y).bin_matrix
    _equal(sparse.bin_matrix, _jax(jax_bins))


def test_sparse_dataset_trains_as_dense():
    x, y = _sparse_problem(12, n=1500)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    a = lgt.train(p, lgt.Dataset(_NoDense(sp.csr_matrix(x)), label=y),
                  num_boost_round=2, device="cpu")
    b = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=2,
                  device="cpu")
    assert a.model_to_string() == b.model_to_string()


class _Seq(lgt.Sequence):
    def __init__(self, arr, batch_size):
        self.arr = arr
        self.batch_size = batch_size

    def __getitem__(self, idx):
        return self.arr[idx]

    def __len__(self):
        return len(self.arr)


SEQ_CASES = {"one": [(0, 500, 77)],
             "three": [(0, 100, 33), (100, 180, 50), (180, 500, 1000)]}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_bins_match_dense_and_jax(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 6))
    x[rng.random(x.shape) < 0.1] = np.nan
    y = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32)
    params = {"max_bin": 31, "linear_tree": True}
    seqs = [_Seq(x[a:b], bs) for a, b, bs in SEQ_CASES[case]]
    ds = lgt.Dataset(seqs if len(seqs) > 1 else seqs[0], label=y,
                     params=params).construct()._binned
    dense = lgt.Dataset(x, label=y, params=params).construct()._binned
    _equal(ds.bin_matrix, dense.bin_matrix)
    _equal(ds.raw_matrix, dense.raw_matrix)
    assert [m.to_dict() for m in ds.mappers] == \
        [m.to_dict() for m in dense.mappers]

    def jax_seq(lgb):
        class JSeq(lgb.Sequence):
            def __init__(self, arr, batch_size):
                self.arr, self.batch_size = arr, batch_size

            def __getitem__(self, idx):
                return self.arr[idx]

            def __len__(self):
                return len(self.arr)
        js = [JSeq(x[a:b], bs) for a, b, bs in SEQ_CASES[case]]
        return lgb.Dataset(js, label=y, params=params).construct()._binned
    _equal(ds.bin_matrix, _jax(jax_seq).bin_matrix)
    # a validation sequence bins with the training mappers
    valid = lgt.Dataset(_Seq(x[:120], 50), label=y[:120],
                        reference=lgt.Dataset(x, label=y, params=params))
    _equal(valid.construct()._binned.bin_matrix, dense.bin_matrix[:120])
