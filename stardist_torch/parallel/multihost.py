"""Block-wise prediction of a big image spread over the ranks of a process
group, 2D and 3D, with and without a class branch (counterpart of
``stardist_tpu/parallel/multihost.py``).

1. Every rank builds the same ``BlockND.cover`` and takes the blocks
   ``rank, rank + n, ...``;
2. for each of them it runs ``predict_sparse`` and the sparse NMS on the
   model's device;
3. one all-gather (gloo, CPU tensors) exchanges only the survivors' table
   (block id, points, prob, dist, and a multiclass model's class rows): a
   few hundred KB, never an image or a label block;
4. the ownership stitch (labels from the survivors, context crop,
   ``filter_objects``, ``relabel_sequential``, write) runs from the
   gathered table in block order. Two modes:

   - ``stitch="replicated"`` (default): every rank replays the whole
     stitch and holds the whole ``labels_out`` and ``polys_all``;
   - ``stitch="partitioned"``: each rank draws only its own blocks; a
     second small all-gather exchanges each block's count of owned objects
     (the label offsets) and the owned rows (so ``polys_all`` is whole and
     the same on every rank). ``labels_out`` gets this rank's blocks only:
     whole when it is a store that every rank writes (a shared memmap or
     zarr array; the blocks' write regions are disjoint), a partial image
     otherwise.

The result equals ``predict_instances_big``'s: the same ``labels_out``
(replicated), and the same ``polys_all`` keys, types and values except
``nms_counters`` (each rank's own NMS counts, left out). The caller
initializes the process group; without one this is the one-process path.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..big import COORD_KEYS, OBJECT_KEYS
from ..matching import relabel_sequential
from .mesh import world

_GLOO = {}


def _gloo_group(group):
    """A gloo group over the ranks of ``group`` for the host-side tables:
    ``group`` itself when it is gloo, else one made once (every rank calls
    this at the same point)."""
    if dist.get_backend(group) == dist.Backend.GLOO:
        return group
    if group not in _GLOO:
        _GLOO[group] = dist.new_group(backend="gloo")
    return _GLOO[group]


def _allgather(a, group, n_procs):
    """Every rank's numpy array ``a`` (the same shape everywhere), stacked
    in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(n_procs)]
    dist.all_gather(out, t, group=group)
    return np.stack([o.numpy() for o in out])


def _allgather_tables(my, group, n_procs, stats=None):
    """Exchange the ranks' tables of varying length: ``my`` is a dict of
    arrays with one leading length (types kept). Returns the tables joined
    in rank order (sort by block id afterwards for block order). An
    all-gather needs equal sizes, so each rank pads to the largest count."""
    counts = _allgather(np.array([len(next(iter(my.values())))], np.int64), group, n_procs)[:, 0]
    cap = int(counts.max(initial=0))
    out = {}
    for k, v in my.items():
        v = np.asarray(v)
        g = _allgather(np.pad(v, [(0, cap - v.shape[0])] + [(0, 0)] * (v.ndim - 1)), group,
                       n_procs)
        if stats is not None:
            stats["bytes"] = stats.get("bytes", 0) + g.nbytes
        out[k] = np.concatenate([g[p][:counts[p]] for p in range(n_procs)])
    return out


def predict_instances_big_multihost(model, img, axes, block_size, min_overlap, context=None,
                                    labels_out=None, labels_out_dtype=np.int32,
                                    prob_thresh=None, nms_thresh=None, stitch="replicated", *,
                                    stats=None, nms_kwargs=None, **kwargs):
    """Block-wise instance prediction spread over the ranks of the default
    process group (reference multihost.py:74-282). Returns ``(labels_out,
    polys_all)``; see the module docstring for the two stitch modes. ``img``
    is the normalized whole image (every rank holds it, or a zarr-like view
    of it). ``kwargs`` go to ``predict_sparse``; ``nms_kwargs`` (a dict) to
    each block's NMS, as ``predict_instances``' (the reference's NMS
    options: ``samples``, and the scheduling ones, which change nothing).
    ``stats``, if a dict, receives this rank's ``blocks`` and the ``bytes``
    and seconds (``exchange_s``) of its all-gathers."""
    if stitch not in ("replicated", "partitioned"):
        raise ValueError(f"unknown stitch mode: {stitch!r}")
    multiclass = model._is_multiclass()
    ndim = model.config.n_dim
    dev = model.device
    if prob_thresh is None:
        prob_thresh = model.thresholds.prob
    if nms_thresh is None:
        nms_thresh = model.thresholds.nms
    nms_kwargs = dict(nms_kwargs or {})
    if ndim == 3:
        from ..nms import non_maximum_suppression_3d_sparse as _nms
        rays = model.rays

        def nms_sparse(d, p, pts):
            return _nms(d, p, pts, rays, nms_thresh=nms_thresh, device=dev, **nms_kwargs)
    else:
        from ..nms import non_maximum_suppression_sparse as _nms

        def nms_sparse(d, p, pts):
            return _nms(d, p, pts, nms_thresh=nms_thresh, device=dev, **nms_kwargs)

    pid, n_procs, group = world()
    if n_procs > 1:
        group = _gloo_group(group)
    ex = {} if stats is None else stats
    ex.update(bytes=0, exchange_s=0.0)

    def allgather_tables(my):
        t0 = time.perf_counter()
        out = _allgather_tables(my, group, n_procs, ex)
        ex["exchange_s"] += time.perf_counter() - t0
        return out

    def allgather(a):
        t0 = time.perf_counter()
        out = _allgather(a, group, n_procs)
        ex["bytes"] += out.nbytes
        ex["exchange_s"] += time.perf_counter() - t0
        return out

    axes, axes_out, shape_out, _, blocks = model._big_cover(img, axes, block_size, min_overlap,
                                                            context)
    my_blocks = list(range(pid, len(blocks), n_procs))
    ex["blocks"] = len(my_blocks)

    # -- this rank's blocks: forward, candidates and NMS ----------------------
    parts = dict(block_id=[np.zeros(0, np.int32)], points=[np.zeros((0, ndim), np.int64)],
                 prob=[np.zeros(0, np.float32)],
                 dist=[np.zeros((0, model.config.n_rays), np.float32)])
    if multiclass:
        parts["class_prob"] = [np.zeros((0, model.config.n_classes + 1), np.float32)]
    pts_dtype = None
    for bi in my_blocks:
        x = np.asarray(blocks[bi].read(img, axes=axes))
        res = model.predict_sparse(x, axes=axes, prob_thresh=prob_thresh,
                                   show_tile_progress=False, **kwargs)
        if multiclass:
            prob_s, dist_s, pc_s, points_s = res[:4]
        else:
            (prob_s, dist_s, points_s), pc_s = res[:3], None
        pointsi, probi, disti, indsi = nms_sparse(dist_s, prob_s, points_s)
        pts_dtype = np.asarray(pointsi).dtype
        parts["block_id"].append(np.full(len(probi), bi, np.int32))
        parts["points"].append(np.asarray(pointsi, np.int64))
        parts["prob"].append(np.asarray(probi, np.float32))
        parts["dist"].append(np.asarray(disti, np.float32))
        if multiclass:
            parts["class_prob"].append(np.asarray(pc_s, np.float32)[indsi])
    my = {k: np.concatenate(v) for k, v in parts.items()}

    # -- the exchange: survivors only ----------------------------------------
    table = allgather_tables(my) if n_procs > 1 else my
    order = np.argsort(table["block_id"], kind="stable")
    table = {k: v[order] for k, v in table.items()}
    starts = np.searchsorted(table["block_id"], np.arange(len(blocks) + 1))
    # the points' type as one process has it (the table carried
    # int64); a rank without blocks never saw it (-1): take the largest code
    codes = {np.dtype(np.int32): 0, np.dtype(np.int64): 1}
    code = -1 if pts_dtype is None else codes.get(np.dtype(pts_dtype), 1)
    if n_procs > 1:
        code = int(allgather(np.array([code], np.int32)).max())
    table["points"] = table["points"].astype({-1: np.int64, 0: np.int32, 1: np.int64}[code])

    if np.isscalar(labels_out) and bool(labels_out) is False:
        labels_out = None
    elif labels_out is None:
        labels_out = np.zeros(shape_out, dtype=labels_out_dtype)

    def rows(bi, sel=slice(None), return_labels=True):
        """The survivors of block ``bi`` (rows ``sel`` of its slice of the
        table) drawn on the model's device, as ``_render_survivors`` does."""
        sl = slice(starts[bi], starts[bi + 1])
        on = {k: torch.from_numpy(np.ascontiguousarray(v[sl][sel])).to(dev)
              for k, v in table.items() if k != "block_id"}
        block = blocks[bi]
        shape = (tuple(s.stop - s.start for s in block.slice_read(axes_out))
                 if return_labels else None)
        return model._render_survivors(shape, on["dist"], on["points"], on["prob"],
                                       return_labels=return_labels,
                                       prob_class=on.get("class_prob"))

    def stitch_block(bi):
        """One block's labels from the gathered table, context cropped and
        ownership filtered (coordinates already in the whole image)."""
        labels, polys = rows(bi)
        labels = blocks[bi].crop_context(labels, axes=axes_out)
        return blocks[bi].filter_objects(labels, polys, axes=axes_out)

    polys_all = {}

    def join(polys_all):
        return {k: (np.concatenate(v) if k in OBJECT_KEYS else v[0])
                for k, v in polys_all.items()}

    if stitch == "replicated":
        label_offset = 1
        for bi, block in enumerate(blocks):
            labels, polys = stitch_block(bi)
            labels = relabel_sequential(labels, label_offset)[0]
            if labels_out is not None:
                block.write(labels_out, labels, axes=axes_out)
            for key, v in polys.items():
                polys_all.setdefault(key, []).append(v)
            label_offset += len(polys["prob"])
        return labels_out, join(polys_all)

    # -- partitioned: each rank draws only its own blocks ---------------------
    counts = np.zeros(len(blocks), np.int64)
    mine = {}
    own = dict(block_id=[np.zeros(0, np.int32)], row=[np.zeros(0, np.int64)])
    for bi in my_blocks:
        labels, _ = stitch_block(bi)
        # the surviving label ids are (row + 1) of the block's slice of the
        # table (the render order; see Block.filter_objects)
        ids = np.unique(labels)
        owned = (ids[ids > 0] - 1).astype(np.int64)
        mine[bi] = relabel_sequential(labels, 1)[0]
        counts[bi] = len(owned)
        own["block_id"].append(np.full(len(owned), bi, np.int32))
        own["row"].append(owned)
    own = {k: np.concatenate(v) for k, v in own.items()}
    if n_procs > 1:
        counts = allgather(counts).max(axis=0)
    offsets = 1 + np.concatenate([[0], np.cumsum(counts)[:-1]])

    if labels_out is not None:
        for bi in my_blocks:
            labels = mine[bi]
            shifted = np.where(labels > 0, labels + (offsets[bi] - 1), 0).astype(labels.dtype)
            blocks[bi].write(labels_out, shifted, axes=axes_out)

    gathered = allgather_tables(own) if n_procs > 1 else own
    g_order = np.argsort(gathered["block_id"], kind="stable")
    g_bid, g_row = gathered["block_id"][g_order], gathered["row"][g_order]
    g_starts = np.searchsorted(g_bid, np.arange(len(blocks) + 1))

    # polys_all from the owned rows, the same on every rank and as the
    # one-process result's: per block, the survivors' dict of the owned rows,
    # coordinates moved into the whole image as Block.filter_objects does
    for bi, block in enumerate(blocks):
        _, polys = rows(bi, g_row[g_starts[bi]:g_starts[bi + 1]], return_labels=False)
        for k in COORD_KEYS:
            if k in polys:
                polys[k] = block.translate_coordinates(polys[k], axes=axes_out)
        for key, v in polys.items():
            polys_all.setdefault(key, []).append(v)
    return labels_out, join(polys_all)
