"""Block-wise processing of big images (counterpart of ``stardist_tpu/big.py``,
numpy and scipy only).

Covers a large image with overlapping, grid-aligned blocks such that every
object smaller than ``min_overlap`` lies wholly in at least one block's
write region, and exactly one block is *responsible* for it: that
ownership rule makes block-wise prediction
(``StarDistBase.predict_instances_big``) equal to one prediction of the
whole image. The blocks of each axis are computed eagerly as flat arrays
(strides -> round-robin shrink -> extra context -> grid scaling ->
explicit starts), with the reference's geometry, including the extra
context that keeps the write regions of non-neighbouring blocks apart.
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np
from scipy.ndimage import find_objects

from .core.axes import axes_check_and_normalize

OBJECT_KEYS = set(("prob", "points", "coord", "dist", "class_prob", "class_id"))
COORD_KEYS = set(("points", "coord"))


class NotFullyVisible(Exception):
    pass


def _grid_divisible(grid, size, name=None, verbose=True):
    if size % grid == 0:
        return size
    _size = size
    size = math.ceil(size / grid) * grid
    if bool(verbose):
        print(
            f"{verbose if isinstance(verbose, str) else ''}increasing "
            f"'{'value' if name is None else name}' from {_size} to {size} "
            f"to be evenly divisible by {grid} (grid)",
            flush=True,
        )
    assert size % grid == 0
    return size


class Block:
    """One-dimensional block of a chain covering [0, size)."""

    def __init__(self, index, n_blocks, start, size, stride, min_overlap, context,
                 extra_context_start=0, extra_context_end=0, pred=None):
        self.index = index
        self.n_blocks = n_blocks
        self.start = int(start)
        self.size = int(size)
        self.stride = int(stride)
        self.min_overlap = int(min_overlap)
        self.context = int(context)
        self._extra_context_start = int(extra_context_start)
        self._extra_context_end = int(extra_context_end)
        self.pred = pred

    # -- geometry ------------------------------------------------------------

    @property
    def at_begin(self):
        return self.index == 0

    @property
    def at_end(self):
        return self.index == self.n_blocks - 1

    @property
    def end(self):
        return self.start + self.size

    @property
    def overlap(self):
        return self.size - self.stride

    @property
    def context_start(self):
        return 0 if self.at_begin else self.context + self._extra_context_start

    @property
    def context_end(self):
        return 0 if self.at_end else self.context + self._extra_context_end

    @property
    def slice_read(self):
        return slice(self.start, self.end)

    @property
    def slice_crop_context(self):
        """Crop context relative to the read region."""
        return slice(self.context_start, self.size - self.context_end)

    @property
    def slice_write(self):
        return slice(self.start + self.context_start, self.end - self.context_end)

    def is_responsible(self, bbox):
        """Ownership test for a 1D interval bbox=(bmin, bmax) in coordinates
        relative to the context-cropped region. Only one block of a chain
        returns True for any interval smaller than min_overlap; raises
        NotFullyVisible(True/False) when the assumption is violated."""
        bmin, bmax = bbox
        r_start = 0 if self.at_begin else (
            self.pred.overlap - self.pred.context_end - self.context_start)
        r_end = self.size - self.context_start - self.context_end
        assert 0 <= bmin < bmax <= r_end

        if bmin == 0 and bmax >= r_start:
            if bmax == r_end:
                # object spans the entire block (probably larger than the block)
                raise NotFullyVisible(True)
            if not self.at_begin:
                # object spans the entire overlap region: partially visible
                # here and in the predecessor
                raise NotFullyVisible(False)

        if bmax < r_start:
            return False
        if bmax == r_end and not self.at_end:
            return False
        return True

    def __repr__(self):
        text = f"{self.start:03}:{self.end:03}"
        text += f", write={self.slice_write.start:03}:{self.slice_write.stop:03}"
        text += f", size={self.context_start}+{self.size - self.context_start - self.context_end}+{self.context_end}"
        return f"{self.__class__.__name__}({text})"

    # -- construction --------------------------------------------------------

    @staticmethod
    def cover(size, block_size, min_overlap, context, grid=1, verbose=True):
        """Chain of grid-aligned 1D blocks covering [0, size).

        All blocks share block_size/min_overlap/context (only the last block's
        size may differ); starts/ends of all but the last block are multiples
        of grid; write regions of non-neighboring blocks never overlap.
        """
        assert 0 <= min_overlap + 2 * context < block_size <= size
        assert 0 < grid <= block_size
        block_size = _grid_divisible(grid, block_size, name="block_size", verbose=verbose)
        min_overlap = _grid_divisible(grid, min_overlap, name="min_overlap", verbose=verbose)
        context = _grid_divisible(grid, context, name="context", verbose=verbose)
        size_orig = size
        size = _grid_divisible(grid, size, name="size", verbose=False)

        # work in grid units
        g_size = size // grid
        g_block = block_size // grid
        g_overlap = min_overlap // grid
        g_context = context // grid

        base_stride = g_block - (g_overlap + 2 * g_context)
        assert base_stride > 0

        # number of blocks: first block ends at g_block; each additional adds
        # its predecessor's stride
        n = 1
        end = g_block
        while end < g_size:
            n += 1
            end += base_stride
        strides = [base_stride] * (n - 1)  # stride of the last block is unused

        # shrink strides round-robin (cycling over all but the last block)
        excess = end - g_size
        i = 0
        while excess > 0 and n > 1:
            strides[i % (n - 1)] -= 1
            assert strides[i % (n - 1)] > 0
            excess -= 1
            i += 1
        if n == 1:
            assert excess == 0

        starts = np.concatenate([[0], np.cumsum(strides)]).astype(int)
        sizes = [g_block] * n

        # extra context so that write regions of non-neighboring blocks do not
        # overlap; sequential because each step reads the current write
        # boundaries
        extra_s = [0] * n
        extra_e = [0] * n

        def ctx_start(i):
            return 0 if i == 0 else g_context + extra_s[i]

        def ctx_end(i):
            return 0 if i == n - 1 else g_context + extra_e[i]

        for i in range(n - 2):
            w_stop_i = starts[i] + sizes[i] - ctx_end(i)
            w_start_i2 = starts[i + 2] + ctx_start(i + 2)
            overlap_write = w_stop_i - w_start_i2
            if overlap_write > 0:
                half = overlap_write // 2
                extra_e[i] += half
                extra_s[i + 2] += overlap_write - half

        # scale back to pixel units
        starts = [s * grid for s in starts]
        sizes = [s * grid for s in sizes]
        strides = [s * grid for s in strides] + [0]
        extra_s = [v * grid for v in extra_s]
        extra_e = [v * grid for v in extra_e]

        # the last block absorbs the non-divisible remainder
        size_delta = size - size_orig
        assert 0 <= size_delta < grid
        sizes[-1] -= size_delta

        blocks = []
        pred = None
        for i in range(n):
            b = Block(i, n, starts[i], sizes[i],
                      strides[i] if i < n - 1 else sizes[i],
                      min_overlap, context, extra_s[i], extra_e[i], pred=pred)
            blocks.append(b)
            pred = b

        # sanity checks
        assert blocks[0].start == 0 and blocks[-1].end == size_orig
        assert all(b.overlap - 2 * context >= min_overlap for b in blocks[:-1])
        assert all(
            b.slice_write.stop - blocks[i + 1].slice_write.start >= min_overlap
            for i, b in enumerate(blocks[:-1])
        )
        assert all(b.start % grid == 0 and b.end % grid == 0 for b in blocks[:-1])
        if len(blocks) >= 3:
            for i in range(len(blocks) - 2):
                assert blocks[i].slice_write.stop <= blocks[i + 2].slice_write.start
        return blocks


class BlockND:
    """N-dimensional block: one 1D Block per axis + a unique id."""

    def __init__(self, id, blocks, axes):
        self.id = id
        self.blocks = tuple(blocks)
        self.axes = axes_check_and_normalize(axes, length=len(self.blocks))
        self.axis_to_block = dict(zip(self.axes, self.blocks))

    def blocks_for_axes(self, axes=None):
        axes = self.axes if axes is None else axes_check_and_normalize(axes)
        return tuple(self.axis_to_block[a] for a in axes)

    def slice_read(self, axes=None):
        return tuple(t.slice_read for t in self.blocks_for_axes(axes))

    def slice_crop_context(self, axes=None):
        return tuple(t.slice_crop_context for t in self.blocks_for_axes(axes))

    def slice_write(self, axes=None):
        return tuple(t.slice_write for t in self.blocks_for_axes(axes))

    def read(self, x, axes=None):
        return x[self.slice_read(axes)]

    def crop_context(self, labels, axes=None):
        return labels[self.slice_crop_context(axes)]

    def write(self, x, labels, axes=None):
        """Write entries > 0 of labels into the write region of x (zarr-safe)."""
        s = self.slice_write(axes)
        mask = labels > 0
        region = x[s]
        region[mask] = labels[mask]
        x[s] = region

    def is_responsible(self, slices, axes=None):
        return all(
            t.is_responsible((s.start, s.stop))
            for t, s in zip(self.blocks_for_axes(axes), slices)
        )

    def __repr__(self):
        slices = ",".join(f"{a}={t.start:03}:{t.end:03}" for t, a in zip(self.blocks, self.axes))
        return f"{self.__class__.__name__}({self.id}|{slices})"

    def __iter__(self):
        return iter(self.blocks)

    def filter_objects(self, labels, polys, axes=None):
        """Retain only the objects this block is responsible for.

        Assumes label ids in 'labels' map (id-1) to rows of the 'polys'
        entries; coordinates of surviving objects are translated into the
        global frame. Raises RuntimeError if an object violates the
        min_overlap assumption."""
        assert np.issubdtype(labels.dtype, np.integer)
        ndim = len(self.blocks_for_axes(axes))
        assert ndim in (2, 3)
        assert labels.ndim == ndim and labels.shape == tuple(
            s.stop - s.start for s in self.slice_crop_context(axes))

        labels_filtered = np.zeros_like(labels)
        for lbl_id, sl in enumerate(find_objects(labels), 1):
            if sl is None:
                continue
            try:
                if self.is_responsible(tuple(sl), axes):
                    m = labels[sl] == lbl_id
                    labels_filtered[sl][m] = lbl_id
            except NotFullyVisible:
                shape_object = tuple(s.stop - s.start for s in sl)
                shape_min_overlap = tuple(t.min_overlap for t in self.blocks_for_axes(axes))
                raise RuntimeError(
                    f"Found object of shape {shape_object}, which violates the "
                    f"assumption of being smaller than 'min_overlap' {shape_min_overlap}. "
                    "Increase 'min_overlap' to avoid this problem.")

        if polys is None:
            return labels_filtered

        assert isinstance(polys, dict) and any(k in polys for k in COORD_KEYS)
        filtered_labels = np.unique(labels_filtered)
        filtered_ind = [i - 1 for i in filtered_labels if i > 0]
        polys_out = {k: (v[filtered_ind] if k in OBJECT_KEYS else v) for k, v in polys.items()}
        for k in COORD_KEYS:
            if k in polys_out.keys():
                polys_out[k] = self.translate_coordinates(polys_out[k], axes=axes)
        return labels_filtered, polys_out

    def translate_coordinates(self, coordinates, axes=None):
        """Local (read-region) coordinates -> global coordinates."""
        ndim = len(self.blocks_for_axes(axes))
        assert isinstance(coordinates, np.ndarray) and coordinates.ndim >= 2 \
            and coordinates.shape[1] == ndim
        start = [s.start for s in self.slice_read(axes)]
        shape = tuple(1 if d != 1 else ndim for d in range(coordinates.ndim))
        return coordinates + np.array(start).reshape(shape)

    @staticmethod
    def cover(shape, axes, block_size, min_overlap, context, grid=1):
        """Grid-aligned ND cover = Cartesian product of per-axis 1D covers."""
        shape = tuple(shape)
        n = len(shape)
        axes = axes_check_and_normalize(axes, length=n)
        if np.isscalar(block_size):
            block_size = n * [block_size]
        if np.isscalar(min_overlap):
            min_overlap = n * [min_overlap]
        if np.isscalar(context):
            context = n * [context]
        if np.isscalar(grid):
            grid = n * [grid]
        assert n == len(block_size) == len(min_overlap) == len(context) == len(grid)
        cover_1d = [Block.cover(*args) for args in zip(shape, block_size, min_overlap, context, grid)]
        return tuple(BlockND(i, blocks, axes) for i, blocks in enumerate(product(*cover_1d)))


class Polygon:
    """Rasterized 2D polygon helper (mask within its bbox), drawn on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, coord, bbox=None, shape_max=None, *, device="cuda"):
        from .geometry.geom2d import polygons_to_label_coord
        self.bbox = self.coords_bbox(coord, shape_max=shape_max) if bbox is None else bbox
        self.coord = coord - np.array([r[0] for r in self.bbox]).reshape(2, 1)
        self.slice = tuple(slice(*r) for r in self.bbox)
        self.shape = tuple(r[1] - r[0] for r in self.bbox)
        self.mask = polygons_to_label_coord(self.coord[np.newaxis], shape=self.shape,
                                            device=device) > 0

    @staticmethod
    def coords_bbox(*coords, shape_max=None):
        assert all(isinstance(c, np.ndarray) and c.ndim == 2 and c.shape[0] == 2 for c in coords)
        if shape_max is None:
            shape_max = (np.inf, np.inf)
        coord = np.concatenate(coords, axis=1)
        mins = np.maximum(0, np.floor(np.min(coord, axis=1))).astype(int)
        maxs = np.minimum(shape_max, np.ceil(np.max(coord, axis=1))).astype(int)
        return tuple(zip(tuple(mins), tuple(maxs)))


class Polyhedron:
    """Rasterized 3D polyhedron helper (mask within its bbox), drawn on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, dist, origin, rays, bbox=None, shape_max=None, *, device="cuda"):
        from .geometry.geom3d import polyhedron_to_label
        self.bbox = self.coords_bbox((dist, origin), rays=rays, shape_max=shape_max) \
            if bbox is None else bbox
        self.slice = tuple(slice(*r) for r in self.bbox)
        self.shape = tuple(r[1] - r[0] for r in self.bbox)
        _origin = origin.reshape(1, 3) - np.array([r[0] for r in self.bbox]).reshape(1, 3)
        self.mask = polyhedron_to_label(dist[np.newaxis], _origin, rays, shape=self.shape,
                                        verbose=False, device=device).astype(bool)

    @staticmethod
    def coords_bbox(*dist_origin, rays, shape_max=None):
        dists, points = zip(*dist_origin)
        assert all(isinstance(d, np.ndarray) and d.ndim == 1 and len(d) == len(rays) for d in dists)
        assert all(isinstance(p, np.ndarray) and p.ndim == 1 and len(p) == 3 for p in points)
        dists = np.stack(dists)[..., np.newaxis]
        points = np.stack(points)[:, np.newaxis]
        verts = rays.vertices[np.newaxis]
        coord = np.concatenate(dists * verts + points, axis=0)
        if shape_max is None:
            shape_max = (np.inf, np.inf, np.inf)
        mins = np.maximum(0, np.floor(np.min(coord, axis=0))).astype(int)
        maxs = np.minimum(shape_max, np.ceil(np.max(coord, axis=0))).astype(int)
        return tuple(zip(tuple(mins), tuple(maxs)))
