"""Text data files: CSV, TSV and LibSVM, with the metadata side files.

The port's own copy of ``lightgbm_tpu/io/loader.py`` (reference
src/io/parser.cpp, dataset_loader.cpp:203, metadata.cpp), with numpy
only: the card's host has no pandas, and the JAX package's C++ parser
(``src/native/``) stays the JAX package's.  The format is detected as
the JAX package's native parser detects it (a data line whose tokens
after the first are mostly ``idx:value`` is LibSVM; otherwise tab
separated when the line has tabs and no commas, else comma separated).
A delimited file is read by ``np.loadtxt`` (``np.genfromtxt`` when a
field is missing or not a number: ``""``, ``NA``, ``N/A``, ``nan``,
``null`` read as NaN); a LibSVM file is split once per line and its
``idx:value`` tokens converted and scattered in whole arrays.

The column specs are the JAX package's: ``label_column`` (default 0),
``weight_column``, ``group_column`` (query ids, made per-query counts)
and ``ignore_column``, each an index or ``name:<column>`` with
``header=true``; the side files ``<file>.weight`` and ``<file>.query``
/ ``<file>.group``; :func:`load_init_score_file` reads
``<file>.init``.
"""
from __future__ import annotations

import itertools
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils import log

MISSING = ("", "na", "n/a", "nan", "null")


def _first_data_line(path: str, skip_first: bool) -> str:
    with open(path, "r") as f:
        first = f.readline()
        if skip_first:
            first = f.readline() or first
    return first.rstrip("\r\n")


def detect_format(line: str) -> Tuple[bool, str]:
    """``(is_libsvm, separator)`` of a data line, as the JAX package's
    native parser decides (``src/native/tgb_native.cpp``
    ``DetectFormat``)."""
    tokens = line.replace("\t", " ").split()
    colon = sum(1 for t in tokens[1:] if ":" in t)
    if len(tokens) > 1 and colon >= max(1, (len(tokens) - 1) // 2):
        return True, " "
    return False, "\t" if ("\t" in line and "," not in line) else ","


def _parse_column_spec(spec: str, names: Optional[List[str]]
                       ) -> Optional[int]:
    spec = (spec or "").strip()
    if not spec:
        return None
    if spec.startswith("name:"):
        nm = spec[5:]
        if names and nm in names:
            return names.index(nm)
        log.fatal("Could not find column %s in data file", nm)
    try:
        return int(spec)
    except ValueError:
        if names and spec in names:
            return names.index(spec)
    log.fatal("Bad column specifier %r", spec)


def _to_float(tokens: np.ndarray) -> np.ndarray:
    """f64 of an array of number strings; the missing spellings and any
    other string that is no number read as NaN."""
    try:
        return tokens.astype(np.float64)
    except ValueError:
        out = np.full(tokens.shape, np.nan)
        for i, t in enumerate(tokens.ravel()):
            if t.strip().lower() not in MISSING:
                try:
                    out.flat[i] = float(t)
                except ValueError:
                    pass
        return out


def _load_delimited(path: str, sep: str, header: bool) -> np.ndarray:
    kw = dict(delimiter=sep, dtype=np.float64, skiprows=int(header),
              comments=None, ndmin=2)
    try:
        return np.loadtxt(path, **kw)
    except ValueError:
        # a missing or non-numeric field
        x = np.genfromtxt(path, delimiter=sep, dtype=str,
                          skip_header=int(header), comments=None,
                          autostrip=True)
        return _to_float(np.atleast_2d(x))


def _load_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        rows = [line.split() for line in f
                if line.strip() and not line.startswith("#")]
    labels = _to_float(np.array([r[0] for r in rows], dtype=object
                                ).astype(str))
    counts = np.array([len(r) - 1 for r in rows], np.int64)
    toks = np.array(list(itertools.chain.from_iterable(r[1:] for r in rows)),
                    dtype=str)
    row_of = np.repeat(np.arange(len(rows)), counts)
    if toks.size:
        idx_s, colon, val_s = np.char.partition(toks, ":").T
        keep = colon == ":"
        idx = idx_s[keep].astype(np.int64)
        vals = _to_float(val_s[keep])
        row_of = row_of[keep]
    else:
        idx = np.zeros(0, np.int64)
        vals = np.zeros(0)
    cols = int(idx.max()) + 1 if idx.size else 0
    if cols <= 0:
        log.fatal("libsvm file %s has no features", path)
    x = np.zeros((len(rows), cols), np.float64)
    ok = idx >= 0
    x[row_of[ok], idx[ok]] = vals[ok]
    return x, labels


def load_text_file(path: str, config: Optional[Config] = None):
    """``(features [n, f] f64, label, weight, group)`` of a text file,
    what ``lightgbm_tpu.io.loader.load_text_file`` gives."""
    cfg = config or Config()
    line = _first_data_line(path, cfg.header)
    is_libsvm, sep = detect_format(line)
    names = None
    if is_libsvm:
        x, y = _load_libsvm(path)
        label_idx = None
    else:
        x, y = _load_delimited(path, sep, cfg.header), None
        if cfg.header:
            with open(path) as f:
                head = f.readline().rstrip("\r\n")
            names = [t.strip() for t in
                     head.split("\t" if "\t" in line else ",")]
        label_idx = _parse_column_spec(cfg.label_column or "0", names)

    weight_idx = _parse_column_spec(cfg.weight_column, names)
    group_idx = _parse_column_spec(cfg.group_column, names)
    drop: List[int] = []
    if cfg.ignore_column:
        for tok in str(cfg.ignore_column).split(","):
            idx = _parse_column_spec(tok, names)
            if idx is not None:
                drop.append(idx)
    label = y
    weight = group = None
    if label_idx is not None:
        label = x[:, label_idx]
        drop.append(label_idx)
    if weight_idx is not None:
        weight = x[:, weight_idx]
        drop.append(weight_idx)
    if group_idx is not None:
        # per-row query ids to per-query counts
        group = np.unique(x[:, group_idx], return_counts=True)[1]
        drop.append(group_idx)
    if drop:
        x = x[:, [j for j in range(x.shape[1]) if j not in set(drop)]]

    if weight is None and os.path.exists(path + ".weight"):
        weight = np.loadtxt(path + ".weight", dtype=np.float64).reshape(-1)
        log.info("Loading weights from %s.weight", os.path.basename(path))
    if group is None:
        for ext in (".query", ".group"):
            if os.path.exists(path + ext):
                group = np.loadtxt(path + ext, dtype=np.int64).reshape(-1)
                log.info("Loading query boundaries from %s%s",
                         os.path.basename(path), ext)
                break
    return x, label, weight, group


def load_init_score_file(path: str) -> Optional[np.ndarray]:
    """The init scores of ``<path>.init``, None without the file."""
    p = path + ".init"
    if os.path.exists(p):
        log.info("Loading initial scores from %s", os.path.basename(p))
        return np.loadtxt(p, dtype=np.float64)
    return None
