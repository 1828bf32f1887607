"""Compiled forest serving on one CUDA device (or, when asked, on the
CPU through the kernel's plain PyTorch version).

* :class:`ServingModel` -- one-time ``from_booster`` build: every tree
  stacked into padded node arrays plus the per-feature quantizer
  tables, identified by a content digest equal to the JAX build's;
* :class:`ServingEngine` -- bucketed dispatch through the hand-written
  traversal kernel (``ops/serve_kernel.py``, ``csrc/serve_traverse.cu``)
  with a per-bucket score-buffer pool the kernel writes in place;
* :class:`ServingQueue` -- async dispatch for the latency-bounded
  small-batch path.
"""
from .engine import ServingEngine, ServingQueue
from .model import ServingModel

__all__ = ["ServingModel", "ServingEngine", "ServingQueue"]
