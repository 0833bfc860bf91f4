"""Qualitative result figures (image / ground truth / prediction panels).

The counterpart of ``aide_tpu.evaluation.plots``, which follows the
reference's plotting helper. matplotlib is imported only when a figure is
drawn: the rest of the port does not need it."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def save_comparison_figure(
    path: str,
    image: np.ndarray,
    target: np.ndarray,
    predictions: Sequence[np.ndarray],
    titles: Optional[Sequence[str]] = None,
) -> None:
    """Save a 1-row panel: input slice, ground truth, one column per
    prediction. ``image`` (H, W[, C]); masks (H, W) binary."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = [image if image.ndim == 2 else image[..., 0], target, *predictions]
    names = ["image", "ground truth"] + list(
        titles or [f"pred {i + 1}" for i in range(len(predictions))]
    )
    fig, axes = plt.subplots(1, len(panels), figsize=(3 * len(panels), 3))
    for ax, panel, name in zip(axes, panels, names):
        ax.imshow(np.asarray(panel), cmap="gray")
        ax.set_title(name)
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
