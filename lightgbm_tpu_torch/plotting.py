"""Plotting utilities.

Counterpart of ``lightgbm_tpu/plotting.py`` (reference
python-package/lightgbm/plotting.py): ``plot_importance``,
``plot_metric``, ``plot_split_value_histogram``, ``plot_tree`` and
``create_tree_digraph``.  matplotlib and graphviz are imported inside
the functions (neither is needed to import the package); tree rendering
without graphviz raises ImportError, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster
from .utils.log import LightGBMError

__all__ = ["plot_importance", "plot_metric", "plot_split_value_histogram",
           "plot_tree", "create_tree_digraph"]


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a list or tuple of 2 elements")


def _get_ax(ax, figsize):
    import matplotlib.pyplot as plt
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    return ax


def plot_importance(
    booster: Booster,
    ax=None,
    height: float = 0.2,
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = "Feature importance",
    xlabel: Optional[str] = "Feature importance",
    ylabel: Optional[str] = "Features",
    importance_type: str = "split",
    max_num_features: Optional[int] = None,
    ignore_zero: bool = True,
    figsize: Optional[Tuple[float, float]] = None,
    grid: bool = True,
    precision: Optional[int] = 3,
    **kwargs: Any,
):
    """Horizontal bar chart of feature importances (plotting.py:36)."""
    importance = booster.feature_importance(importance_type=importance_type)
    names = booster.feature_name()
    tuples = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if not tuples:
        raise ValueError("Cannot plot trees with zero importance")
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    ax = _get_ax(ax, figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    fmt = "{}" if importance_type == "split" else f"{{:.{precision}f}}"
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, fmt.format(x), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(
    booster: Union[Dict, Any],
    metric: Optional[str] = None,
    dataset_names: Optional[List[str]] = None,
    ax=None,
    xlim=None,
    ylim=None,
    title: Optional[str] = "Metric during training",
    xlabel: Optional[str] = "Iterations",
    ylabel: Optional[str] = "@metric@",
    figsize=None,
    grid: bool = True,
):
    """Metric curves from record_evaluation results (plotting.py:196)."""
    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):
        eval_results = booster.evals_result_
    else:
        raise TypeError(
            "booster must be a dict from record_evaluation or a fitted "
            "sklearn model with evals_result_")
    if not eval_results:
        raise ValueError("eval results are empty")

    names = dataset_names or list(eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = next(iter(first.keys()))
    ax = _get_ax(ax, figsize)
    for name in names:
        if metric not in eval_results.get(name, {}):
            continue
        vals = eval_results[name][metric]
        ax.plot(range(len(vals)), vals, label=name)
    ax.legend(loc="best")
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel.replace("@metric@", metric))
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(
    booster: Booster,
    feature: Union[int, str],
    bins=None,
    ax=None,
    width_coef: float = 0.8,
    xlim=None,
    ylim=None,
    title: Optional[str] = "Split value histogram for feature @feature@",
    xlabel: Optional[str] = "Feature split value",
    ylabel: Optional[str] = "Count",
    figsize=None,
    grid: bool = True,
):
    """Histogram of split thresholds used for one feature
    (plotting.py:119)."""
    if isinstance(feature, str):
        feature = booster.feature_name().index(feature)
    values = []
    for t in booster._models:
        ni = t.num_leaves - 1
        for i in range(ni):
            if int(t.split_feature[i]) == feature and not (
                    int(t.decision_type[i]) & 1):
                values.append(float(t.threshold[i]))
    if not values:
        raise ValueError(
            f"Cannot plot split value histogram, feature {feature} was not "
            "used in splitting")
    hist, edges = np.histogram(values, bins=bins or "auto")
    centers = (edges[:-1] + edges[1:]) / 2
    width = width_coef * (edges[1] - edges[0])
    ax = _get_ax(ax, figsize)
    ax.bar(centers, hist, width=width, align="center")
    if title is not None:
        ax.set_title(title.replace("@feature@", str(feature)))
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.grid(grid)
    return ax


def _tree_to_dot(tree, tree_index: int, feature_names: List[str],
                 precision: int = 3) -> str:
    """Graphviz dot source for one tree (plotting.py _to_graphviz)."""
    lines = [f'digraph Tree{tree_index} {{',
             'graph [nodesep=0.05, ranksep=0.3, rankdir=LR];',
             'node [shape=record, style=rounded];']
    ni = tree.num_leaves - 1

    def leaf_label(l):
        return (f'leaf{l} [label="leaf {l}: '
                f'{tree.leaf_value[l]:.{precision}f}"];')

    if ni == 0:
        lines.append(leaf_label(0))
    for i in range(ni):
        f = int(tree.split_feature[i])
        name = (feature_names[f] if f < len(feature_names)
                else f"Column_{f}")
        if int(tree.decision_type[i]) & 1:
            cond = f"{name} in categories"
        else:
            cond = f"{name} <= {tree.threshold[i]:.{precision}f}"
        lines.append(f'split{i} [label="{cond}\\ngain: '
                     f'{tree.split_gain[i]:.{precision}f}"];')
        for child, tag in ((int(tree.left_child[i]), "yes"),
                           (int(tree.right_child[i]), "no")):
            tgt = f"leaf{~child}" if child < 0 else f"split{child}"
            if child < 0:
                lines.append(leaf_label(~child))
            lines.append(f'split{i} -> {tgt} [label="{tag}"];')
    lines.append("}")
    return "\n".join(lines)


def create_tree_digraph(
    booster: Booster,
    tree_index: int = 0,
    precision: Optional[int] = 3,
    **kwargs: Any,
):
    """graphviz.Source for one tree (plotting.py:360).  Needs the optional
    ``graphviz`` package."""
    try:
        import graphviz
    except ImportError as e:
        raise ImportError(
            "You must install graphviz and restart your session to plot "
            "trees.") from e
    models = booster._models
    if not 0 <= tree_index < len(models):
        raise IndexError(f"tree_index {tree_index} out of range")
    dot = _tree_to_dot(models[tree_index], tree_index,
                       booster.feature_name(), precision or 3)
    return graphviz.Source(dot, **kwargs)


def plot_tree(booster: Booster, ax=None, tree_index: int = 0,
              figsize=None, precision: Optional[int] = 3, **kwargs: Any):
    """Render one tree onto a matplotlib axis (plotting.py:470)."""
    import io
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                precision=precision, **kwargs)
    import matplotlib.image as mpimg
    ax = _get_ax(ax, figsize)
    s = io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img, aspect="auto")
    ax.axis("off")
    return ax
