"""Tiled prediction utilities (csbdeep tile_iterator replacement; a copy of
``stardist_tpu/core/tiling.py``).

Splits an array into per-axis tiles made of whole "blocks" (block_sizes =
network divisibility), with ``n_block_overlaps`` blocks of context on each
side. Yields (tile, s_src, s_dst):
- tile: the overlapping input slice,
- s_src: slice *within the tile* selecting the non-overlap core,
- s_dst: slice in the full array where that core belongs.
Contract matches csbdeep.internals.predict.tile_iterator as used by
reference StarDistBase (stardist/models/base.py:24,436-439,496-509).

``equal_tiles=True`` makes every yielded tile the same shape (edge tiles
keep extra context), so every tile's forward runs at one shape.
"""
from __future__ import annotations

import itertools

import numpy as np


def _axis_tiles(n_blocks, n_tiles, n_overlap):
    """Per-axis tile layout in block units: list of (t0, t1, c0, c1) with the
    core [t0, t1) and the context-expanded range [c0, c1)."""
    n_tiles = min(n_tiles, n_blocks)
    bounds = np.linspace(0, n_blocks, n_tiles + 1).round().astype(int)
    out = []
    for i in range(n_tiles):
        t0, t1 = int(bounds[i]), int(bounds[i + 1])
        c0 = max(0, t0 - n_overlap)
        c1 = min(n_blocks, t1 + n_overlap)
        out.append((t0, t1, c0, c1))
    return out


def total_n_tiles(x, n_tiles, block_sizes, n_block_overlaps):
    total = 1
    for s, t, b, o in zip(x.shape, n_tiles, block_sizes, n_block_overlaps):
        assert s % b == 0
        total *= len(_axis_tiles(s // b, t, o))
    return total


def tile_iterator(x, n_tiles, block_sizes, n_block_overlaps, equal_tiles=False):
    """Iterate overlapping tiles of ``x``.

    All sizes in ``block_sizes`` must divide the corresponding axis of ``x``.
    If ``equal_tiles``, every tile is expanded (within array bounds) to the
    maximum tile shape so a single compiled function handles all tiles.
    """
    assert x.ndim == len(n_tiles) == len(block_sizes) == len(n_block_overlaps)
    layouts = []
    for s, t, b, o in zip(x.shape, n_tiles, block_sizes, n_block_overlaps):
        assert s % b == 0, f"axis size {s} not divisible by block {b}"
        layouts.append(_axis_tiles(s // b, t, o))

    if equal_tiles:
        # expand each tile's context range to the global max width per axis
        new_layouts = []
        for axis, (layout, s, b) in enumerate(zip(layouts, x.shape, block_sizes)):
            n_blocks = s // b
            width = max(c1 - c0 for _, _, c0, c1 in layout)
            fixed = []
            for t0, t1, c0, c1 in layout:
                # grow [c0, c1) to exactly `width` blocks within [0, n_blocks]
                grow = width - (c1 - c0)
                c0 = max(0, c0 - grow)
                c1 = min(n_blocks, c0 + width)
                c0 = c1 - width
                fixed.append((t0, t1, c0, c1))
            new_layouts.append(fixed)
        layouts = new_layouts

    for combo in itertools.product(*layouts):
        sl_tile, sl_src, sl_dst = [], [], []
        for (t0, t1, c0, c1), b in zip(combo, block_sizes):
            sl_tile.append(slice(c0 * b, c1 * b))
            sl_src.append(slice((t0 - c0) * b, (t1 - c0) * b))
            sl_dst.append(slice(t0 * b, t1 * b))
        yield x[tuple(sl_tile)], tuple(sl_src), tuple(sl_dst)
