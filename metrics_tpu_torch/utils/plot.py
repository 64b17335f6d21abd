"""Matplotlib-optional plot helpers backing ``Metric.plot()``
(port of ``metrics_tpu/utils/plot.py``).

Values are tensors, numpy arrays or numbers (or lists of them for time series);
each is copied to a numpy array on the host on entry. matplotlib is imported
inside the plot functions only, so the module imports without it.
"""

from __future__ import annotations

from math import ceil, floor, sqrt
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from metrics_tpu_torch.utils.imports import _MATPLOTLIB_AVAILABLE

_PLOT_OUT_TYPE = Tuple[object, object]


def _host(x: Any) -> np.ndarray:
    """``x`` as a numpy array on the host (a tensor is detached and copied off its device)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _error_on_missing_matplotlib() -> None:
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(
            "Plot function expects `matplotlib` to be installed. Please install with `pip install matplotlib`"
        )


def plot_single_or_multi_val(
    val: Union[Any, Sequence[Any]],
    ax: Optional[Any] = None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Plot one metric value, a per-class value vector, or a time series of either.

    A single array is rendered as point markers (scalar: one dot; vector: one dot per
    class/label); a list/tuple of arrays is a time series with steps on the x-axis.
    Bounds are drawn as dashed lines with an "Optimal value" marker on the better one.

    Returns ``(fig, ax)``; raises ``ModuleNotFoundError`` without matplotlib.
    """
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots() if ax is None else (None, ax)
    ax.get_xaxis().set_visible(False)

    if not isinstance(val, (list, tuple)):
        arr = np.atleast_1d(_host(val))
        if arr.size == 1:
            ax.plot(arr, marker="o", markersize=10)
        else:
            for i, v in enumerate(arr):
                label = f"{legend_name} {i}" if legend_name else f"{i}"
                ax.plot(i, v, marker="o", markersize=10, linestyle="None", label=label)
    else:
        series = np.stack([_host(v) for v in val], 0)  # [steps] or [steps, classes]
        multi_series = series.ndim != 1
        series = series.T if multi_series else series[None, :]
        for i, v in enumerate(series):
            label = (f"{legend_name} {i}" if legend_name else f"{i}") if multi_series else ""
            ax.plot(v, marker="o", markersize=10, linestyle="-", label=label)
        ax.get_xaxis().set_visible(True)
        ax.set_xlabel("Step")
        ax.set_xticks(np.arange(series.shape[1]))

    handles, labels = ax.get_legend_handles_labels()
    if handles and labels:
        ax.legend(handles, labels, loc="upper center", bbox_to_anchor=(0.5, 1.15), ncol=3, fancybox=True, shadow=True)

    ylim = ax.get_ylim()
    if lower_bound is not None and upper_bound is not None:
        factor = 0.1 * (upper_bound - lower_bound)
    else:
        factor = 0.1 * (ylim[1] - ylim[0])
    ax.set_ylim(
        bottom=lower_bound - factor if lower_bound is not None else ylim[0] - factor,
        top=upper_bound + factor if upper_bound is not None else ylim[1] + factor,
    )

    ax.grid(True)
    ax.set_ylabel(name if name is not None else None)

    xlim = ax.get_xlim()
    factor = 0.1 * (xlim[1] - xlim[0])
    bounds = [b for b in (lower_bound, upper_bound) if b is not None]
    if bounds:
        ax.hlines(bounds, xlim[0], xlim[1], linestyles="dashed", colors="k")
    if higher_is_better is not None:
        if lower_bound is not None and not higher_is_better:
            ax.set_xlim(xlim[0] - factor, xlim[1])
            ax.text(xlim[0], lower_bound, s="Optimal \n value", horizontalalignment="center", verticalalignment="center")
        if upper_bound is not None and higher_is_better:
            ax.set_xlim(xlim[0] - factor, xlim[1])
            ax.text(xlim[0], upper_bound, s="Optimal \n value", horizontalalignment="center", verticalalignment="center")
    return fig, ax


def _get_col_row_split(n: int) -> Tuple[int, int]:
    """Near-square rows x cols split for n panels."""
    nsq = sqrt(n)
    if int(nsq) ** 2 == n:
        return int(nsq), int(nsq)
    if floor(nsq) * ceil(nsq) >= n:
        return floor(nsq), ceil(nsq)
    return ceil(nsq), ceil(nsq)


def trim_axs(axs: Any, nb: int) -> Any:
    """Keep the first ``nb`` axes of a subplot grid, removing the rest from the figure."""
    if not isinstance(axs, np.ndarray):
        return axs
    flat = list(axs.flat)
    for ax in flat[nb:]:
        ax.remove()
    return np.asarray(flat[:nb])


def plot_confusion_matrix(
    confmat: Any,
    add_text: bool = True,
    labels: Optional[List[str]] = None,
) -> _PLOT_OUT_TYPE:
    """Render an ``[N, N]`` confusion matrix (or ``[L, 2, 2]`` multilabel stack)."""
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    confmat = _host(confmat)
    if confmat.ndim == 3:  # multilabel
        nb, n_classes = confmat.shape[0], 2
        rows, cols = _get_col_row_split(nb)
    else:
        nb, n_classes, rows, cols = 1, confmat.shape[0], 1, 1

    if labels is not None and confmat.ndim != 3 and len(labels) != n_classes:
        raise ValueError(
            "Expected number of elements in arg `labels` to match number of labels in confmat but "
            f"got {len(labels)} and {n_classes}"
        )
    labels = labels if labels is not None else np.arange(n_classes).tolist()

    fig, axs = plt.subplots(nrows=rows, ncols=cols)
    axs = trim_axs(axs, nb)
    for i in range(nb):
        ax = axs[i] if isinstance(axs, np.ndarray) else axs
        if confmat.ndim == 3:
            ax.set_title(f"Label {i}", fontsize=15)
        ax.imshow(confmat[i] if confmat.ndim == 3 else confmat)
        ax.set_xlabel("True class", fontsize=15)
        ax.set_ylabel("Predicted class", fontsize=15)
        ax.set_xticks(list(range(n_classes)))
        ax.set_yticks(list(range(n_classes)))
        ax.set_xticklabels(labels, rotation=45, fontsize=10)
        ax.set_yticklabels(labels, rotation=25, fontsize=10)
        if add_text:
            for ii in range(n_classes):
                for jj in range(n_classes):
                    v = confmat[i, ii, jj] if confmat.ndim == 3 else confmat[ii, jj]
                    ax.text(jj, ii, str(v.item()), ha="center", va="center", fontsize=15)
    return fig, axs
