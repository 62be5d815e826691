"""Matplotlib helpers: random label colormaps and polygon overlays
(a copy of stardist_tpu/plot/plot.py; reference
stardist/plot/plot.py)."""
from __future__ import annotations

import numpy as np


def random_label_cmap(n=2 ** 16, h=(0, 1), l=(0.4, 1), s=(0.2, 0.8)):
    """Random HLS colormap for label images (label 0 -> black)."""
    import colorsys
    import matplotlib

    rng = np.random.uniform
    cols = np.stack(
        [colorsys.hls_to_rgb(_h, _l, _s)
         for _h, _l, _s in zip(rng(*h, n), rng(*l, n), rng(*s, n))]
    )
    cols[0] = 0
    return matplotlib.colors.ListedColormap(cols)


def _plot_polygon(x, y, score, color):
    import matplotlib.pyplot as plt

    a, b = list(x), list(y)
    a += a[:1]
    b += b[:1]
    plt.plot(a, b, "--", alpha=1, linewidth=score, zorder=1, color=color)


def _draw_polygons(coord, score=None, poly_idx=None, grid=(1, 1), cmap=None, show_dist=False):
    """Draw polygon overlays on the current matplotlib axes.

    coord.shape = (n_polys, 2, n_rays); points are scaled by ``grid``.
    """
    import matplotlib.pyplot as plt

    if cmap is None:
        cmap = random_label_cmap(len(coord) + 1)
    if score is None:
        score = np.ones(len(coord))
    if poly_idx is None:
        poly_idx = np.arange(len(coord))

    for point_idx, c in enumerate(coord):
        if point_idx not in poly_idx:
            continue
        s = score[point_idx]
        y, x = c[0], c[1]
        col = cmap.colors[(1 + point_idx) % len(cmap.colors)]
        if show_dist:
            cy, cx = np.mean(y), np.mean(x)
            for _y, _x in zip(y, x):
                plt.plot((cx, _x), (cy, _y), "-", color=col, linewidth=0.4 * s, alpha=0.5)
        _plot_polygon(x, y, 3 * s, color=col)


def draw_polygons(coord, score=None, poly_idx=None, grid=(1, 1), cmap=None, show_dist=False):
    """Draw polygons on top of the currently shown image."""
    return _draw_polygons(coord, score=score, poly_idx=poly_idx, grid=grid,
                          cmap=cmap, show_dist=show_dist)
