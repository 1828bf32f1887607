"""Static kernel-contract analyzer of the PyTorch / CUDA port.

The counterpart of ``lightgbm_tpu/analysis``.  The JAX analyzer traces
Pallas entry points to jaxprs; the port's kernels are CUDA built by
``nvcc`` and called through ``ctypes``, so this one reads their registered
launch geometry (``registry.py``, ``entries.py``), the resources ``ptxas``
gave each kernel (``resources.py``: ``cuobjdump -res-usage`` on the card,
the checked-in ``resources_sm90a.txt`` elsewhere) and the sources
(``astutil.py``), and proves the kernels' contracts before anything is
launched:

``align``       the vector-access rule: rows moved in V-byte words have
                a stride and base that are multiples of V (the lane
                contract's counterpart);
``smem``        static + dynamic shared memory within 232,448 B a block,
                the opt-in above 48 KB, registers x threads within
                65,536, spills, and each wrapper's shared-memory formula
                against the library's own (the VMEM budget's);
``async-copy``  every committed async-copy group waited on, no read of a
                copy's destination before its wait (the DMA pass's);
``host``        no device-to-host read in a kernel wrapper or on the
                training loop's path (the host-sync pass's);
``purity``      registered "knob off => the same program" pins, the
                program being the ATen ops and kernel-wrapper calls a
                CPU run makes;
``routing``     the golden routing matrix and the audit of its cells.

CLI: ``python -m lightgbm_tpu_torch.analysis [--strict] [--json]
[--fixture NAME]... [--resources FILE|built]``.  Findings schema
``lightgbm_tpu_torch/analysis/v1``.  Allowlist ``analysis/allowlist.json``:
every entry needs a justification.  Red-team fixtures, one seeded
violation per pass, live in ``analysis/fixtures/``.  It imports neither
JAX nor the JAX package, builds nothing and launches nothing.
"""
from .findings import SCHEMA, Finding  # noqa: F401
from .run import PASS_NAMES, run_analysis  # noqa: F401
