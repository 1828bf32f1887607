"""Build the port's CUDA sources with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles alone
into ``build/lib<name>-<hash>.so`` inside the package directory (listed
in ``.gitignore``), keyed by the content hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds and
an unchanged one loads the library already there.  The build is ``nvcc
-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``:
no PyTorch headers, so a source builds in seconds.  No source gets
``--use_fast_math`` or ``-ftz=true``.  The sources whose arithmetic must
equal PyTorch's operation by operation (the gradient formulas, the split
gains, the linear-leaf moments, TreeSHAP) also get ``-fmad=false``
(:data:`SOURCE_FLAGS`), so ``nvcc`` contracts no ``a * b + c`` into an
``fma``.  :func:`build` starts one ``nvcc`` per missing source, all at
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from ..utils.log import LightGBMError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("serve_traverse", "hist_comb", "partition", "stream_grad",
           "fused_split", "apply_find", "hist_rows", "partition_3ph",
           "linear_fit", "tree_shap", "analysis_fixtures", "probes",
           "legacy_probes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source flags added to NVCC_FLAGS
SOURCE_FLAGS: Dict[str, tuple] = {
    "stream_grad": ("-fmad=false",),
    "apply_find": ("-fmad=false",),
    "linear_fit": ("-fmad=false",),
    "tree_shap": ("-fmad=false",),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build done here
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise LightGBMError("nvcc not found (PATH, CUDA_HOME/bin, "
                        "/usr/local/cuda/bin): the port's CUDA kernels "
                        "are built from lightgbm_tpu_torch/csrc at first "
                        "use")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source whose library is missing, one
    ``nvcc`` process per source, all started together.  Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        BUILD_LOGS[n] = log
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise LightGBMError("CUDA kernel build failed: "
                            + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
