"""Source readers of the port's analyzer: Python through ``ast`` and CUDA
through a scanner that strips comments and strings.

Python (the counterpart of ``lightgbm_tpu/analysis/astutil.py``, which
reads Pallas kernel bodies): the port's kernel bodies are CUDA, so what
is read here is the Python around them.

- A **kernel wrapper** is a module-level function of ``ops/*.py`` that
  launches a kernel: its body counts a launch (``<fn>.launches += 1``)
  or calls a library loader (``_lib()``, ``_rows_lib()``,
  ``_build.load``).  Plain versions (``*_ref``) run only on the CPU and
  are exempt.
- The **training loop's path** is every function of ``ops/grow.py``,
  the boosters (``models/gbdt.py``, ``goss.py``, ``rf.py``,
  ``dart.py``) and the
  per-row draws (``utils/random.py``) but ``__init__`` and the plain
  versions: each runs once an iteration or more often (per tree, per
  split).

:func:`host_pulls` finds the calls that wait for the device and copy to
the host: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``np.asarray`` / ``numpy.asarray`` and ``torch.cuda.synchronize``.

CUDA: :func:`strip_cuda` blanks comments and string literals (keeping
line numbers), except the strings of ``asm`` statements, which are where
``cp.async`` and ``mbarrier`` instructions live; :func:`cuda_kernels`
cuts a source into its ``__global__`` functions.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
REPO = PACKAGE.parent

PULL_METHODS = ("item", "tolist", "cpu", "numpy")
LOADERS = ("_lib", "_rows_lib")


def rel_path(path) -> str:
    """``path`` relative to the repository root when it lies inside."""
    p = Path(path).resolve()
    try:
        return str(p.relative_to(REPO))
    except ValueError:
        return str(p)


def _dotted(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def pull_of(call: ast.Call) -> str:
    """The host pull ``call`` makes, or ''."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in PULL_METHODS \
            and not call.args:
        return f".{fn.attr}()"
    name = _dotted(fn)
    if name in ("np.asarray", "numpy.asarray", "torch.cuda.synchronize"):
        return name
    return ""


def host_pulls(fn: ast.AST) -> Iterator[Tuple[int, str]]:
    """(line, what) of every host pull inside ``fn``, nested functions
    included."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            what = pull_of(node)
            if what:
                yield node.lineno, what


def is_wrapper(fn: ast.FunctionDef) -> bool:
    """Whether ``fn`` launches a kernel (see the module docstring)."""
    if fn.name.endswith("_ref"):
        return False
    for node in ast.walk(fn):
        if (isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == "launches"):
            return True
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in LOADERS or name.endswith("_build.load"):
                return True
    return False


def functions(tree: ast.Module) -> Iterator[Tuple[str, ast.FunctionDef]]:
    """(qualified name, node) of every module-level function and method."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


@dataclass
class PyModule:
    """One parsed Python source and its role."""
    path: Path
    role: str             # "wrappers" | "loop"

    @property
    def rel(self) -> str:
        return rel_path(self.path)

    def tree(self) -> ast.Module:
        return ast.parse(self.path.read_text(), filename=str(self.path))

    def hits(self) -> Iterator[Tuple[str, int, str]]:
        """(function, line, what) of every host pull the role forbids."""
        for qual, fn in functions(self.tree()):
            short = qual.rsplit(".", 1)[-1]
            if short.endswith("_ref"):
                continue
            if self.role == "wrappers" and not is_wrapper(fn):
                continue
            if self.role == "loop" and short == "__init__":
                continue
            for line, what in host_pulls(fn):
                yield qual, line, what


def default_python_modules() -> List[PyModule]:
    ops = sorted((PACKAGE / "ops").glob("*.py"))
    return ([PyModule(p, "wrappers") for p in ops]
            + [PyModule(PACKAGE / rel, "loop") for rel in (
                "ops/grow.py", "models/gbdt.py", "models/goss.py",
                "models/rf.py", "models/dart.py", "utils/random.py")])


# ---------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------
def strip_cuda(text: str) -> str:
    """``text`` with comments and string literals blanked (newlines kept,
    so line numbers hold), except the strings of ``asm`` statements."""
    blank = (lambda t: re.sub(r"[^\n]", " ", t))  # noqa: E731
    out: List[str] = []
    i, n, stmt = 0, len(text), 0     # stmt: where the statement began
    while i < n:
        c = text[i]
        if text.startswith("//", i) or text.startswith("/*", i):
            j = (text.find("\n", i) if c == "/" and text[i + 1] == "/"
                 else text.find("*/", i + 2) + 2)
            j = n if j < 2 or j < i else j
            out.append(blank(text[i:j]))
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
            keep = c == '"' and re.search(r"\basm\b", text[stmt:i])
            out.append(text[i:j] if keep else
                       c + blank(text[i + 1:j - 1]) + c)
        else:
            j = i + 1
            if c in ";{}":
                stmt = j
            out.append(c)
        i = j
    return "".join(out)


@dataclass
class CudaKernel:
    name: str
    line: int             # line of the signature
    body: str             # stripped text of the body, braces excluded
    body_line: int        # line of the body's first character


_GLOBAL = re.compile(r"__global__\b")
_BOUNDS = re.compile(r"__launch_bounds__\s*\([^)]*\)")


def cuda_kernels(stripped: str) -> List[CudaKernel]:
    """The ``__global__`` functions of a stripped source."""
    out = []
    for m in _GLOBAL.finditer(stripped):
        open_at = stripped.find("{", m.end())
        if open_at < 0:
            continue
        head = _BOUNDS.sub(" ", stripped[m.end():open_at])
        found = re.search(r"([A-Za-z_]\w*)\s*\(", head)
        name = found.group(1) if found else "?"
        depth, j = 0, open_at
        while j < len(stripped):
            if stripped[j] == "{":
                depth += 1
            elif stripped[j] == "}":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        out.append(CudaKernel(
            name=name, line=stripped.count("\n", 0, m.start()) + 1,
            body=stripped[open_at + 1:j],
            body_line=stripped.count("\n", 0, open_at) + 1))
    return out


def default_cuda_files() -> List[Path]:
    csrc = PACKAGE / "csrc"
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
