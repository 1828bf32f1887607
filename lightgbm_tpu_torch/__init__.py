"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

The port trains GBDT, GOSS and random-forest models (bagged or not) for
the binary, multiclass, regression and cross-entropy objectives on one
NVIDIA GPU and serves LightGBM model files there.  Training (``train``,
``Dataset``, ``Booster``) grows trees on a physically partitioned row
matrix with hand-written CUDA kernels for the histogram
(``csrc/hist_comb.cu``) and the partition scan and copyback
(``csrc/partition.cu``); serving scores
rows through a CUDA forest traversal kernel
(``csrc/serve_traverse.cu``).  The kernels are built with ``nvcc`` at
first use.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.

The training API is the JAX package's: custom objectives (a callable
``objective``) and metrics (``feval``), ``cv`` with ``CVBooster``,
``reset_parameter``, ``Booster.refit`` (the rows' leaves from the
traversal kernel's leaf entry), ``dump_model`` and
``feature_importance``; ``Dataset`` takes dense, scipy sparse,
``Sequence`` and text-file input and the binary cache.  The package
imports neither JAX nor ``lightgbm_tpu``.
"""
from .basic import Booster, Dataset, Sequence
from .callback import (early_stopping, log_evaluation, record_evaluation,
                       reset_parameter)
from .engine import CVBooster, cv, train
from .serve import ServingEngine, ServingModel, ServingQueue
from .utils.log import LightGBMError, register_log_callback, set_verbosity

__version__ = "0.2.0"

__all__ = ["Booster", "Dataset", "Sequence", "train", "cv", "CVBooster",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "ServingModel",
           "ServingEngine", "ServingQueue", "LightGBMError",
           "register_log_callback", "set_verbosity"]
