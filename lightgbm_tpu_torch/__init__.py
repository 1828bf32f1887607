"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

This slice serves LightGBM model files on one NVIDIA GPU: a ``Booster``
loaded from model text scores rows through a hand-written CUDA forest
traversal kernel (``csrc/serve_traverse.cu``, built with ``nvcc`` at
first use).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.  The
package imports neither JAX nor ``lightgbm_tpu``.
"""
from .basic import Booster
from .serve import ServingEngine, ServingModel, ServingQueue
from .utils.log import LightGBMError, register_log_callback, set_verbosity

__version__ = "0.1.0"

__all__ = ["Booster", "ServingModel", "ServingEngine", "ServingQueue",
           "LightGBMError", "register_log_callback", "set_verbosity"]
