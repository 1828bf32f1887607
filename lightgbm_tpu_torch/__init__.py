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
``Sequence`` and text-file input and the binary cache.  So are its
public edges: ``Booster.predict(pred_contrib=True)`` (TreeSHAP in the
CUDA kernel ``csrc/tree_shap.cu``) and ``pred_early_stop``, the
scikit-learn estimators (``LGBMClassifier`` and the others, which take
``device=``), the CLI (``python -m lightgbm_tpu_torch config=train.conf``,
``application.py``), the C API (``c_api.py``) and the plots
(``plotting.py``, with matplotlib).  The package imports neither JAX nor
``lightgbm_tpu``.
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

try:  # the estimators stand on plain bases without scikit-learn
    from .sklearn import (LGBMClassifier, LGBMModel, LGBMRanker,
                          LGBMRegressor)
    __all__ += ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]
except ImportError:  # pragma: no cover
    pass

try:  # plotting imports matplotlib and graphviz inside each function
    from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                           plot_split_value_histogram, plot_tree)
    __all__ += ["plot_importance", "plot_metric",
                "plot_split_value_histogram", "plot_tree",
                "create_tree_digraph"]
except ImportError:  # pragma: no cover
    pass
