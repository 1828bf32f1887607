"""Kernel-entry registry of the port's analyzer.

The JAX package's analyzer traces each registered entry point to a jaxpr
(``lightgbm_tpu/analysis/registry.py``).  The port's kernels are ``ctypes``
calls into libraries ``nvcc`` built (``ops/_build.py``), so there is no
program to trace: an entry is instead the kernel's registered launch
geometry at a main path's shape, the block, the dynamic shared memory
from the wrapper's own Python formula and every tensor argument's
layout, and the passes hold that against the resources ``ptxas`` gave the
kernel (``resources.py``) and against the sources.  Nothing is allocated
and nothing is launched.

Two registries live here:

* ``KERNELS``      name -> :class:`KernelEntry` (align, smem, with the
                   cluster rules);
* ``PURITY_PINS``  name -> maker of the variants of one "knob off =>
                   the same program" invariant (purity).

This module stays import-light: ``entries.py`` fills the tables when
:func:`collect` imports it.
"""
from __future__ import annotations

from dataclasses import astuple, dataclass
from typing import Callable, Dict, Optional, Tuple


class _ByValue:
    """Equality and hash by the fields' values and the class's name, not
    the class object: an entry built before the package's modules were
    dropped from ``sys.modules`` and imported again (as test processes
    that also hold the JAX package's tests do) still equals the one
    registered after."""

    def __eq__(self, other):
        return (type(other).__qualname__ == type(self).__qualname__
                and astuple(self) == astuple(other))

    def __hash__(self):
        return hash((type(self).__qualname__, astuple(self)))


@dataclass(frozen=True, eq=False)
class TensorArg(_ByValue):
    """One tensor a kernel reads or writes, as the kernel addresses it."""
    name: str
    dtype: str                 # torch dtype name: float32, int32, uint8, ...
    shape: Tuple[int, ...]
    row_stride: int            # bytes from one row to the next
    vec: int                   # bytes of each access the kernel makes
    base_offset: int = 0       # bytes from a 256-byte aligned allocation


@dataclass(frozen=True, eq=False)
class KernelEntry(_ByValue):
    """One registered kernel launch at one shape."""
    name: str
    source: str                # csrc/<source>.cu
    symbol: str                # the __global__ function as ``resources``
                               # normalises it: "hist_comb_partial<CombRows>"
    block: Tuple[int, int, int]
    dyn_smem: int              # the wrapper's Python formula, bytes
    args: Tuple[TensorArg, ...] = ()
    wrapper: str = ""          # ops module and function that launches it
    replaces: str = ""         # file:line of the TPU kernel
    # the library's own shared-memory export and its arguments, held
    # against dyn_smem on the card: ("hist_comb_smem_bytes", (28, 256))
    export: Optional[Tuple[str, Tuple[int, ...]]] = None
    fixture: bool = False
    # the grid where the wrapper passes it to the library (the fixture
    # kernels', held against the JAX fixtures' grids); None where the
    # library sizes it
    grid: Optional[Tuple[int, int, int]] = None
    # blocks of the thread-block cluster the launch asks for
    # (cudaLaunchAttributeClusterDimension); None for no cluster
    cluster: Optional[int] = None

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]


KERNELS: Dict[str, KernelEntry] = {}
# variants() -> [(variant_name, fn), ...]; fn() runs the variant's program
# on the CPU (purity.py records it)
PURITY_PINS: Dict[str, Callable] = {}

_collected = False


def register_kernel(entry: KernelEntry) -> KernelEntry:
    """Add ``entry`` to ``KERNELS``; a second entry of one name raises."""
    if entry.name in KERNELS and KERNELS[entry.name] != entry:
        raise ValueError(f"kernel entry {entry.name!r} registered twice")
    KERNELS[entry.name] = entry
    return entry


def register_purity_pin(name: str):
    """Decorator: ``variants() -> [(variant_name, fn), ...]``.  The purity
    pass records every variant's program and requires them equal."""
    def deco(variants: Callable) -> Callable:
        PURITY_PINS[name] = variants
        return variants
    return deco


def collect() -> Dict[str, KernelEntry]:
    """Import the module that carries the registrations; returns the
    kernel table.  Idempotent."""
    global _collected
    if not _collected:
        from . import entries  # noqa: F401
        _collected = True
    return KERNELS


DTYPE_BYTES = {"uint8": 1, "uint16": 2, "int32": 4, "float32": 4,
               "bfloat16": 2, "int64": 8, "float64": 8}


def vec_arg(name: str, dtype: str, shape, vec: int,
            base_offset: int = 0) -> TensorArg:
    """A row-major tensor whose rows are its last dimension."""
    shape = tuple(int(s) for s in shape)
    return TensorArg(name, dtype, shape,
                     row_stride=shape[-1] * DTYPE_BYTES[dtype], vec=vec,
                     base_offset=base_offset)

