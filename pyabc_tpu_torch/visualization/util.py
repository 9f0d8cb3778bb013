"""Shared visualization helpers (port of
``pyabc_tpu/visualization/util.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union


def to_lists_or_default(histories, labels: Optional[Union[List, str]] = None
                        ) -> Tuple[list, list]:
    """Normalize (histories, labels) to equal-length lists
    (reference util.py ``to_lists_or_default``)."""
    if not isinstance(histories, (list, tuple)):
        histories = [histories]
    histories = list(histories)
    if labels is None:
        labels = [f"run {getattr(h, 'id', i)}"
                  for i, h in enumerate(histories)]
    elif isinstance(labels, str):
        labels = [labels]
    return histories, list(labels)


def format_plot_matrix(arr_ax, par_names: List[str]):
    """Hide inner tick labels of a square plot matrix and label the outer
    edge (reference kde.py matrix formatting)."""
    n = len(par_names)
    for i in range(n):
        for j in range(n):
            ax = arr_ax[i][j]
            if i < n - 1:
                ax.set_xlabel("")
                ax.tick_params(labelbottom=False)
            else:
                ax.set_xlabel(par_names[j])
            if j > 0:
                ax.set_ylabel("")
                ax.tick_params(labelleft=False)
            else:
                ax.set_ylabel(par_names[i])
    return arr_ax
