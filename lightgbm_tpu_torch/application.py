"""Config-file driven CLI application.

Counterpart of ``lightgbm_tpu/application.py`` (reference src/main.cpp +
src/application/application.{h,cpp}): the tasks ``train | predict |
convert_model | refit | save_binary`` driven by ``key=value`` argv tokens
and an optional ``config=<file>`` of further ``key=value`` lines, argv
winning over the file (application.cpp:31-87).  LightGBM's example
configs (examples/*/train.conf) run unchanged:

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

The device comes from the parameters (``utils.device.device_from_params``):
``device_type=cpu`` trains and predicts on the CPU, any other value on
the card.  Prediction output matches the JAX package's: one line a row,
tab-separated for several columns.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .engine import train as train_api
from .utils import log
from .utils.device import device_from_params


def _parse_argv(argv: List[str]) -> Config:
    """argv tokens + config file -> Config (application.cpp:50
    LoadParameters: argv wins over config-file lines)."""
    tokens = [t for t in argv if "=" in t]
    argv_cfg = {}
    for tok in tokens:
        k, v = tok.split("=", 1)
        argv_cfg[k.strip()] = v.strip().strip('"')
    conf_path = argv_cfg.get("config", argv_cfg.get("config_file", ""))
    file_tokens: List[str] = []
    if conf_path:
        with open(conf_path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if line and "=" in line:
                    file_tokens.append(line)
    # argv first: duplicate keys warn and first-one-wins in from_params
    merged = tokens + file_tokens
    return Config.from_params(merged)


class Application:
    """Reference Application (application.cpp:31): parse, dispatch task."""

    def __init__(self, argv: List[str]):
        self.config = _parse_argv(argv)
        self.device = device_from_params(self.config.device_type)

    def run(self) -> None:
        task = self.config.task
        if task == "train":
            self.train()
        elif task in ("predict", "prediction", "test"):
            self.predict()
        elif task == "convert_model":
            self.convert_model()
        elif task == "refit":
            self.refit()
        elif task == "save_binary":
            self.save_binary()
        else:
            log.fatal("Unknown task %s", task)

    # ------------------------------------------------------------------
    def _load_train_data(self) -> Dataset:
        cfg = self.config
        if not cfg.data:
            log.fatal("No training data specified (data=...)")
        params = {k: v for k, v in cfg.explicit_params().items()}
        return Dataset(cfg.data, params=params)

    def train(self) -> None:
        cfg = self.config
        train_set = self._load_train_data()
        valid_sets = []
        valid_names = []
        for i, path in enumerate(cfg.valid):
            valid_sets.append(Dataset(path, reference=train_set))
            valid_names.append(os.path.splitext(os.path.basename(path))[0]
                               or f"valid_{i}")
        init_model = cfg.input_model if cfg.input_model else None
        out = cfg.output_model or "LightGBM_model.txt"
        callbacks = []
        if cfg.snapshot_freq > 0:
            # periodic model snapshots (reference gbdt.cpp:345-349 saves
            # model.txt.snapshot_iter_<n> every snapshot_freq iterations)
            def _snapshot(env):
                it = env.iteration + 1
                if it % cfg.snapshot_freq == 0:
                    env.model.save_model(f"{out}.snapshot_iter_{it}")
            callbacks.append(_snapshot)
        booster = train_api(
            cfg.explicit_params(), train_set,
            num_boost_round=cfg.num_iterations,
            valid_sets=valid_sets, valid_names=valid_names,
            init_model=init_model,
            keep_training_booster=False,
            callbacks=callbacks,
            device=self.device,
        )
        booster.save_model(out)
        log.info("Finished training; model saved to %s", out)

    # ------------------------------------------------------------------
    def predict(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            log.fatal("task=predict requires input_model=")
        if not cfg.data:
            log.fatal("task=predict requires data=")
        booster = Booster(model_file=cfg.input_model, device=self.device)
        from .io.loader import load_text_file
        X, _, _, _ = load_text_file(cfg.data, config=cfg)
        pred = booster.predict(
            X,
            raw_score=cfg.predict_raw_score,
            pred_leaf=cfg.predict_leaf_index,
            pred_contrib=cfg.predict_contrib,
            num_iteration=cfg.num_iteration_predict,
        )
        out = cfg.output_result or "LightGBM_predict_result.txt"
        arr = np.asarray(pred)
        if arr.ndim == 1:
            np.savetxt(out, arr, fmt="%.18g")
        else:
            np.savetxt(out, arr, fmt="%.18g", delimiter="\t")
        log.info("Finished prediction; results saved to %s", out)

    # ------------------------------------------------------------------
    def convert_model(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            log.fatal("task=convert_model requires input_model=")
        if cfg.convert_model_language not in ("", "cpp"):
            log.warning("convert_model_language=%s unsupported; using cpp",
                        cfg.convert_model_language)
        from .models.codegen import model_to_ifelse_cpp
        from .models.model_text import load_model_from_string
        with open(cfg.input_model) as fh:
            code = model_to_ifelse_cpp(load_model_from_string(fh.read()))
        out = cfg.convert_model or "gbdt_prediction.cpp"
        with open(out, "w") as fh:
            fh.write(code)
        log.info("Converted model saved to %s", out)

    # ------------------------------------------------------------------
    def refit(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            log.fatal("task=refit requires input_model=")
        if not cfg.data:
            log.fatal("task=refit requires data=")
        booster = Booster(model_file=cfg.input_model, device=self.device)
        from .io.loader import load_text_file
        X, y, w, _ = load_text_file(cfg.data, config=cfg)
        if y is None:
            log.fatal("refit data must contain labels")
        booster2 = booster.refit(X, y, weight=w,
                                 decay_rate=cfg.refit_decay_rate)
        out = cfg.output_model or "LightGBM_model.txt"
        booster2.save_model(out)
        log.info("Refitted model saved to %s", out)

    # ------------------------------------------------------------------
    def save_binary(self) -> None:
        cfg = self.config
        ds = self._load_train_data().construct()
        out = (cfg.output_model if cfg.output_model.endswith(".bin")
               else cfg.data + ".bin")
        ds._binned.save_binary(out)
        log.info("Binary dataset saved to %s", out)


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    Application(argv).run()
