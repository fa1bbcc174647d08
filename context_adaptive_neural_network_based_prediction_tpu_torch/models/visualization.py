"""PNN visualization: context arrangements and learned-filter grids.

The port of the JAX package's `models/visualization.py`
(`arrange_context_portions` :15, `save_context_arrangement` :42,
`fc_first_layer_filters` :49, `conv_first_layer_filters` :67,
`plot_filter_grid` :74), numpy on the host: the (above, left, target)
arrangement of a context as one image, and the pixel-facing weights of a
PNN as a grid of filters (matplotlib, imported when called).  Params are
the JAX layout's numpy dicts (`zoo.load_frozen_params`,
`zoo.params_to_numpy`).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import images


def _plane(a):
    a = np.asarray(a)
    return a[..., 0] if a.ndim == 3 else a


def arrange_context_portions(portion_above: np.ndarray,
                             portion_left: np.ndarray,
                             target: np.ndarray | None = None,
                             mean_training: float = 0.0) -> np.ndarray:
    """Places above (w, 3w[, 1]), left (2w, w[, 1]) and the target into one
    3w x 3w uint8 image; mean-removed inputs get the mean added back, the
    unused quadrant is white."""
    a = _plane(portion_above)
    l = _plane(portion_left)
    w = a.shape[0]
    canvas = np.full((3 * w, 3 * w), 255.0)
    canvas[0:w, :] = a + mean_training
    canvas[w:3 * w, 0:w] = l + mean_training
    if target is not None:
        canvas[w:2 * w, w:2 * w] = _plane(target) + mean_training
    return np.clip(np.round(canvas), 0, 255).astype(np.uint8)


def save_context_arrangement(path: str, portion_above, portion_left,
                             target=None, mean_training: float = 0.0,
                             enlargement: int = 4) -> None:
    images.save_image(path, arrange_context_portions(
        portion_above, portion_left, target, mean_training), enlargement)


def fc_first_layer_filters(params: dict, width_target: int) -> np.ndarray:
    """The FC net's first-layer weights as per-unit context filters:
    (n_hidden, 3w, 3w) float32, the above part on top, the left part below
    it on the left, the unused quadrant NaN."""
    fc = params.get("fully_connected", params)
    w0 = np.asarray(fc["weights_0"])  # (5w^2, hidden)
    w = width_target
    n_hidden = w0.shape[1]
    out = np.full((n_hidden, 3 * w, 3 * w), np.nan, dtype=np.float32)
    above = w0[: 3 * w * w].reshape(w, 3 * w, n_hidden)
    left = w0[3 * w * w:].reshape(2 * w, w, n_hidden)
    out[:, 0:w, :] = above.transpose(2, 0, 1)
    out[:, w:, 0:w] = left.transpose(2, 0, 1)
    return out


def conv_first_layer_filters(params: dict,
                             branch: str = "branch_above") -> np.ndarray:
    """(n_maps, k, k) first-layer kernels of a conv branch."""
    conv = params.get("convolutional", params)
    kernels = np.asarray(conv[branch]["convolution_0"]["weights"])
    return kernels[:, :, 0, :].transpose(2, 0, 1)


def plot_filter_grid(filters: np.ndarray, path_to_png: str, *,
                     max_filters: int = 64, title: str = "") -> None:
    """Saves a grid image of filters (n, h, w), each normalized to [0, 1]
    (NaN drawn white)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(filters.shape[0], max_filters)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(1.3 * cols, 1.3 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            f = filters[i]
            finite = np.isfinite(f)
            lo, hi = f[finite].min(), f[finite].max()
            ax.imshow(np.where(finite, (f - lo) / (hi - lo + 1e-9), 1.0),
                      cmap="gray", vmin=0, vmax=1)
    fig.suptitle(title)
    os.makedirs(os.path.dirname(path_to_png) or ".", exist_ok=True)
    fig.savefig(path_to_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
