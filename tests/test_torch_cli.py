"""The CLI (``application.py``, ``python -m lightgbm_tpu_torch``) and
``convert_model`` of the PyTorch port against the JAX package, on the
CPU.

Both CLIs run in-process (``Application(argv).run()``) on one conf file
(``device_type = cpu``, which the JAX package reads and ignores); only
``__main__`` runs in a subprocess.  ``task=train``: trees equal in
structure and leaves within ``test_torch_train.LEAF_RTOL`` of the tree's
largest (the JAX package on its row-order route); ``task=predict`` of
one model within 1e-6 (``%.18g`` lines), the contributions
(``predict_contrib=true``) the port's ``pred_contrib``; ``task=refit``
of a regression model leaves within 1e-5; ``task=save_binary`` caches
that bin and label the same rows equally; ``snapshot_freq`` writes the
same snapshots.  ``convert_model``'s C++ is byte for byte the JAX
package's for binary, multiclass and categorical models, and compiled
with ``g++`` it gives the f64 host walk's raw scores bit for bit.  The
JAX CLI refits a loaded binary model with the regression objective (its
``Config`` default wins over the model's objective); the port takes the
model's (witnessed).
"""
import contextlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees, host_raw
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.application import Application, _parse_argv
from lightgbm_tpu_torch.models.codegen import model_to_ifelse_cpp
from lightgbm_tpu_torch.models.model_text import load_model_from_string
from test_torch_train import (LEAF_RTOL, ROUTE_KNOBS, ROW_ORDER_ROUTE,
                              _data, _purge)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def jax_package():
    """The JAX package imported fresh on its row-order route, purged
    again after."""
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ROW_ORDER_ROUTE)
    try:
        _purge()
        import lightgbm_tpu as lgb
        import lightgbm_tpu.application as japp
        yield lgb, japp
    finally:
        restore_env_knobs(saved)
        _purge()


def _csv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.17g")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    x, y = _data(3072, 6, 11)
    xr, yr = _data(600, 6, 22, objective="regression")
    conf = d / "train.conf"
    conf.write_text("task = train\nobjective = binary\n"
                    "num_iterations = 3\nnum_leaves = 15\n"
                    "# a comment line\nmin_data_in_leaf = 5\n"
                    "device_type = cpu\nverbosity = -1\n")
    return {"dir": d, "x": x, "y": y, "xr": xr, "yr": yr, "conf": str(conf),
            "train": _csv(d / "train.csv", x, y),
            "reg": _csv(d / "reg.csv", xr, yr)}


def _trees(path):
    return lgt.Booster(model_file=str(path), device="cpu")._models


def test_cli_train_and_predict_match_jax(files):
    d = files["dir"]
    argv = [f"config={files['conf']}", f"data={files['train']}"]
    Application(argv + [f"output_model={d / 'port.txt'}"]).run()
    with jax_package() as (_, japp):
        japp.Application(argv + [f"output_model={d / 'jax.txt'}"]).run()
    cmp = compare_trees(_trees(d / "port.txt"), _trees(d / "jax.txt"),
                        LEAF_RTOL)
    assert cmp["ok"] and cmp["trees"] == 3, cmp
    pred = ["task=predict", f"data={files['train']}", "device_type=cpu",
            f"input_model={d / 'port.txt'}"]
    Application(pred + [f"output_result={d / 'p_port.txt'}"]).run()
    with jax_package() as (_, japp):
        japp.Application(pred + [f"output_result={d / 'p_jax.txt'}"]).run()
    got = np.loadtxt(d / "p_port.txt")
    np.testing.assert_allclose(got, np.loadtxt(d / "p_jax.txt"), atol=1e-6)
    bst = lgt.Booster(model_file=str(d / "port.txt"), device="cpu")
    assert np.array_equal(got, bst.predict(files["x"]))
    Application(pred + ["predict_contrib=true",
                        f"output_result={d / 'c_port.txt'}"]).run()
    assert np.array_equal(np.loadtxt(d / "c_port.txt"),
                          bst.predict(files["x"], pred_contrib=True))


def test_cli_refit_matches_jax(files):
    d = files["dir"]
    Application([f"config={files['conf']}", f"data={files['reg']}",
                 "objective=regression",
                 f"output_model={d / 'reg.txt'}"]).run()
    refit = ["task=refit", f"data={files['reg']}", "device_type=cpu",
             f"input_model={d / 'reg.txt'}", "refit_decay_rate=0.5"]
    Application(refit + [f"output_model={d / 'r_port.txt'}"]).run()
    with jax_package() as (_, japp):
        japp.Application(refit + [f"output_model={d / 'r_jax.txt'}"]).run()
    base, got, want = (_trees(d / f) for f in ("reg.txt", "r_port.txt",
                                                "r_jax.txt"))
    cmp = compare_trees(got, want, 1e-5)
    assert cmp["ok"], cmp
    assert not all(np.array_equal(a.leaf_value, b.leaf_value)
                   for a, b in zip(got, base))


def test_jax_cli_refit_takes_regression(files):
    """On a binary model the JAX CLI's refit uses the regression
    objective; the port's uses the model's (its ``Booster.refit``)."""
    d = files["dir"]
    Application([f"config={files['conf']}", f"data={files['train']}",
                 f"output_model={d / 'bin.txt'}"]).run()
    refit = ["task=refit", f"data={files['train']}", "device_type=cpu",
             f"input_model={d / 'bin.txt'}"]
    Application(refit + [f"output_model={d / 'rb_port.txt'}"]).run()
    with jax_package() as (lgb, japp):
        japp.Application(refit + [f"output_model={d / 'rb_jax.txt'}"]).run()
        jb = lgb.Booster(model_file=str(d / "bin.txt"))
        as_l2 = jb.refit(files["x"], files["y"], objective="regression")
    port = _trees(d / "rb_port.txt")
    api = lgt.Booster(model_file=str(d / "bin.txt"), device="cpu").refit(
        files["x"], files["y"])._models
    assert all(np.array_equal(a.leaf_value, b.leaf_value)
               for a, b in zip(port, api))
    assert compare_trees(_trees(d / "rb_jax.txt"), as_l2._models,
                         1e-12)["ok"]
    assert not compare_trees(port, _trees(d / "rb_jax.txt"), 1e-3)["ok"]


def test_cli_save_binary_matches_jax(files):
    d = files["dir"]
    argv = ["task=save_binary", f"data={files['train']}", "max_bin=63"]
    Application(argv + [f"output_model={d / 'port.bin'}"]).run()
    with jax_package() as (lgb, japp):
        japp.Application(argv + [f"output_model={d / 'jax.bin'}"]).run()
        jax_ds = lgb.Dataset(str(d / "jax.bin")).construct()._binned
    port_ds = lgt.Dataset(str(d / "port.bin")).construct()._binned
    cross = lgt.Dataset(str(d / "jax.bin")).construct()._binned
    for ds in (jax_ds, cross):
        assert np.array_equal(port_ds.bin_matrix, ds.bin_matrix)
        assert np.array_equal(port_ds.metadata.label, ds.metadata.label)
    assert port_ds.num_data == 3072


def test_main_snapshot_freq_matches_jax(files):
    """``python -m lightgbm_tpu_torch`` with ``snapshot_freq=2`` over 4
    iterations: the snapshots at 2 and 4 hold the final model's first
    trees, as the JAX CLI's do."""
    d = files["dir"] / "snap"
    d.mkdir()
    argv = [f"config={files['conf']}", f"data={files['train']}",
            "num_iterations=4", "snapshot_freq=2", "num_leaves=7"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch", *argv,
                          f"output_model={d / 'port.txt'}"], cwd=d, env=env,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    with jax_package() as (_, japp):
        japp.Application(argv + [f"output_model={d / 'jax.txt'}"]).run()
    final = _trees(d / "port.txt")
    for it in (2, 4):
        snap = _trees(d / f"port.txt.snapshot_iter_{it}")
        assert compare_trees(final[:it], snap, 0.0)["ok"]
        assert compare_trees(snap, _trees(d / f"jax.txt.snapshot_iter_{it}"),
                             LEAF_RTOL)["ok"]
    assert not (d / "port.txt.snapshot_iter_3").exists()


def test_parse_argv_matches_jax(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text("num_leaves = 7\nlearning_rate=0.3 # inline\n"
                    "objective = binary\n")
    argv = [f"config={conf}", "num_leaves=63", "device_type=cpu"]
    cfg = _parse_argv(argv)
    assert cfg.num_leaves == 63 and cfg.learning_rate == 0.3
    with jax_package() as (_, japp):
        jcfg = japp._parse_argv(argv)
    assert cfg.explicit_params() == jcfg.explicit_params()


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
def test_convert_model_matches_jax_byte_for_byte(kind, tmp_path):
    x, y = _data(500, 6, 23, objective="regression")
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 5}
    cat = "auto"
    if kind == "multiclass":
        y = np.digitize(y, [-0.5, 0.5]).astype(float)
        params.update(objective="multiclass", num_class=3)
    else:
        y = (y > 0).astype(float)
    if kind == "categorical":
        x[:, 1] = np.floor(np.abs(np.nan_to_num(x[:, 1])) * 4)
        cat = [1]
        params.update(min_data_per_group=5, cat_smooth=1.0)
    text = lgt.train(params, lgt.Dataset(x, label=y, categorical_feature=cat),
                     3, device="cpu").model_to_string()
    got = model_to_ifelse_cpp(load_model_from_string(text))
    with jax_package() as (lgb, _):
        from lightgbm_tpu.models.codegen import model_to_ifelse_cpp as jcpp
        want = jcpp(lgb.Booster(model_str=text)._loaded)
    assert got == want
    if kind == "binary":
        _compiled_matches_host_walk(tmp_path, text, x)


def _compiled_matches_host_walk(d, text, x):
    """``task=convert_model``'s C++ compiled with ``g++`` on 16 rows: the
    f64 host walk's raw scores bit for bit."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    (d / "model.txt").write_text(text)
    Application(["task=convert_model", f"input_model={d / 'model.txt'}",
                 f"convert_model={d / 'model.cpp'}"]).run()
    from chip_smoke import CONVERT_MAIN
    f = x.shape[1]
    (d / "main.cpp").write_text(CONVERT_MAIN % (f, f))
    subprocess.run(["g++", "-O1", "-o", str(d / "pred"),
                    str(d / "main.cpp")], check=True, cwd=d, timeout=300)
    rows = np.asarray(x[:16], np.float64)
    inp = "\n".join(" ".join(repr(float(v)) for v in r) for r in rows)
    res = subprocess.run([str(d / "pred")], input=inp, capture_output=True,
                         text=True, check=True, timeout=60)
    got = np.array([float(s) for s in res.stdout.split()])
    bst = lgt.Booster(model_str=text, device="cpu")
    assert np.array_equal(got, host_raw(bst, rows))
    np.testing.assert_allclose(got, bst.predict(rows, raw_score=True),
                               atol=1e-6)
