"""Small helpers shared by the port (the numpy ones copied from
stardist_tpu/utils.py), and the threshold search of
``StarDistBase.optimize_thresholds``."""
from __future__ import annotations

import datetime
import struct
import time
import warnings
from collections import namedtuple
from collections.abc import Iterable
from pathlib import Path
from zipfile import ZIP_DEFLATED, ZipFile

import numpy as np
import torch
from scipy.ndimage import binary_fill_holes, distance_transform_edt, find_objects
from scipy.optimize import minimize_scalar

from .matching import _check_label_array, matching_dataset


def _is_power_of_2(i):
    assert i > 0
    e = np.log2(i)
    return e == int(e)


def _normalize_grid(grid, n):
    try:
        grid = tuple(grid)
        if not (len(grid) == n and all(map(np.isscalar, grid)) and all(map(_is_power_of_2, grid))):
            raise TypeError()
        return tuple(int(g) for g in grid)
    except (TypeError, AssertionError):
        raise ValueError(
            f"grid = {grid} must be a list/tuple of length {n} with values that are power of 2"
        )


def as_tensor_on(x, device):
    """A tensor as it is (on its own device); anything else as a numpy array
    moved to ``device``. A numpy input is not run on the CPU unless the
    caller asks for ``device="cpu"``: with no card, ``"cuda"`` raises."""
    if isinstance(x, torch.Tensor):
        return x
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a numpy input: pass device='cpu' "
                           "to run on the CPU")
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def grid_divisible_patch_size(patch_size, grid, warn=True):
    patch_size, grid = tuple(patch_size), tuple(grid)
    assert len(patch_size) == len(grid)
    rounded = tuple(int(np.ceil(p / g) * g) for p, g in zip(patch_size, grid))
    if rounded != patch_size and warn:
        warnings.warn(
            f"increasing patch_size from {patch_size} to {rounded}, "
            f"since it was not evenly divisible by grid {grid}"
        )
    return rounded


Region = namedtuple("Region", ("label", "slice", "bbox", "centroid", "area"))


def regions(lbl):
    """Minimal regionprops: per-label slice, bbox, centroid, area; bbox as
    (min_0, ..., min_n, max_0, ..., max_n) with exclusive max."""
    _check_label_array(lbl, "lbl")
    out = []
    for i, sl in enumerate(find_objects(lbl), 1):
        if sl is None:
            continue
        mask = lbl[sl] == i
        idx = np.nonzero(mask)
        centroid = tuple(float(np.mean(ii)) + s.start for ii, s in zip(idx, sl))
        bbox = tuple(s.start for s in sl) + tuple(s.stop for s in sl)
        out.append(Region(label=i, slice=sl, bbox=bbox, centroid=centroid, area=int(len(idx[0]))))
    return out


def calculate_extents(lbl, func=np.median):
    """The objects' bounding-box sizes in a label image (or a list of them),
    aggregated per axis by ``func``."""
    if (isinstance(lbl, np.ndarray) and lbl.ndim == 4) or (
        not isinstance(lbl, np.ndarray) and isinstance(lbl, Iterable)
    ):
        return func(np.stack([calculate_extents(y, func) for y in lbl], axis=0), axis=0)
    n = lbl.ndim
    if n not in (2, 3):
        raise ValueError("label image should be 2- or 3-dimensional (or pass a list of these)")
    regs = regions(lbl)
    if len(regs) == 0:
        return np.zeros(n)
    extents = np.array([np.array(r.bbox[n:]) - np.array(r.bbox[:n]) for r in regs])
    return func(extents, axis=0)


def fill_label_holes(lbl_img, **kwargs):
    """Fill the holes of each object of a label image (in its bounding box
    grown by one pixel on interior sides)."""
    filled = np.zeros_like(lbl_img)
    for i, sl in enumerate(find_objects(lbl_img), 1):
        if sl is None:
            continue
        interior = [(s.start > 0, s.stop < sz) for s, sz in zip(sl, lbl_img.shape)]
        grown = tuple(
            slice(s.start - int(w[0]), s.stop + int(w[1])) for s, w in zip(sl, interior)
        )
        shrink = tuple(slice(int(w[0]), -1 if w[1] else None) for w in interior)
        mask_filled = binary_fill_holes(lbl_img[grown] == i, **kwargs)[shrink]
        filled[sl][mask_filled] = i
    return filled


def sample_points(n_samples, mask, prob=None, b=2):
    """``n_samples`` point locations drawn (with numpy's global generator)
    from a boolean 2D mask, at least ``b`` pixels from the border, weighted
    by ``prob`` where it is given."""
    if b is not None and b > 0:
        mask_b = np.zeros_like(mask)
        mask_b[b:-b, b:-b] = True
    else:
        mask_b = True
    points = np.nonzero(mask & mask_b)
    if prob is not None:
        w = prob[points[0], points[1]].astype(np.float64)
        w /= np.sum(w)
        ind = np.random.choice(len(points[0]), n_samples, replace=True, p=w)
    else:
        ind = np.random.choice(len(points[0]), n_samples, replace=True)
    return np.stack((points[0][ind], points[1][ind]), axis=-1)


def edt_prob(lbl_img, anisotropy=None):
    """Per-object normalized Euclidean distance transform (scipy): for every
    pixel of object ``l`` the distance to the nearest pixel not labeled
    ``l``, over the object's largest; background 0. Each object is
    processed in its bounding box grown by one pixel on interior sides."""
    constant_img = lbl_img.min() == lbl_img.max() and lbl_img.flat[0] > 0
    if constant_img:
        lbl_img = np.pad(lbl_img, ((1, 1),) * lbl_img.ndim, mode="constant")
        warnings.warn("EDT of constant label image is ill-defined. (Assuming background around it.)")
    prob = np.zeros(lbl_img.shape, np.float32)
    for i, sl in enumerate(find_objects(lbl_img), 1):
        if sl is None:
            continue
        interior = [(s.start > 0, s.stop < sz) for s, sz in zip(sl, lbl_img.shape)]
        grown = tuple(
            slice(s.start - int(w[0]), s.stop + int(w[1])) for s, w in zip(sl, interior)
        )
        shrink = tuple(slice(int(w[0]), -1 if w[1] else None) for w in interior)
        grown_mask = lbl_img[grown] == i
        mask = grown_mask[shrink]
        edt = distance_transform_edt(grown_mask, sampling=anisotropy)[shrink][mask]
        prob[sl][mask] = edt / (np.max(edt) + 1e-10)
    if constant_img:
        prob = prob[(slice(1, -1),) * lbl_img.ndim].copy()
    return prob


def clear_border(lbl):
    """Remove the objects that touch the image border (for shape-completion
    training)."""
    border = np.zeros(lbl.shape, bool)
    for ax in range(lbl.ndim):
        sl0 = [slice(None)] * lbl.ndim
        sl1 = [slice(None)] * lbl.ndim
        sl0[ax] = 0
        sl1[ax] = -1
        border[tuple(sl0)] = True
        border[tuple(sl1)] = True
    touching = np.unique(lbl[border & (lbl > 0)])
    out = lbl.copy()
    if len(touching):
        out[np.isin(out, touching)] = 0
    return out


def _add_time(timings, key, t0):
    """Add the seconds since ``t0`` to ``timings[key]`` (when timings is a
    dict); returns the clock now."""
    t1 = time.perf_counter()
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + (t1 - t0)
    return t1


def optimize_threshold(Y, Yhat, model, nms_thresh, measure="accuracy",
                       iou_threshs=(0.3, 0.5, 0.7), bracket=None, tol=1e-2,
                       maxiter=20, verbose=1, *, timings=None):
    """Golden-section search over prob_thresh for the best mean matching
    score (``measure`` over ``iou_threshs``) at a fixed ``nms_thresh``
    (reference utils.py:258-330); returns (prob_thresh, score).

    ``Y``: the true label images; ``Yhat``: the dense (prob, dist) numpy maps
    of ``model.predict`` for them. Each image's candidates are extracted
    once, at the bracket's lower edge (``prob > bracket[0]``, the border of
    2), sorted by descending prob (:func:`.nms.descending_order`), and go
    through one NMS (``model._nms_keep``), all on ``model.device``, where
    they stay. Greedy NMS decides a candidate by the candidates before it,
    so a probe's survivors are the kept ones among its prefix: the first n
    candidates, n the count of prob > prob_thresh (compared in f64, as the
    reference's ``np.searchsorted`` does). Each probe draws its survivors
    on the device (``model._render_survivors``), copies the labels to the
    host and matches them there. ``timings``, if a dict, adds up the
    seconds of ``extract``, ``nms``, ``render`` (the raster and the labels'
    copy to the host) and ``matching``, and counts ``probes``."""
    from .nms import _ind_prob_thresh, descending_order
    if not np.isscalar(nms_thresh):
        raise ValueError("nms_thresh must be a scalar")
    iou_threshs = [iou_threshs] if np.isscalar(iou_threshs) else list(iou_threshs)
    values = {}

    if bracket is None:
        max_prob = max(np.max(prob) for prob, dist in Yhat)
        bracket = max_prob / 2, max_prob

    dev = model.device
    grid = torch.tensor(model.config.grid, device=dev)
    t0 = time.perf_counter()
    pre = []
    for prob, dist in Yhat:
        prob, dist = as_tensor_on(prob, dev), as_tensor_on(dist, dev)
        mask = _ind_prob_thresh(prob, bracket[0], b=2)
        scores = prob[mask]
        order = descending_order(scores)
        points = (torch.nonzero(mask)[order] * grid).to(torch.float32)
        pre.append((scores[order], dist[mask][order], points))
    if timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = _add_time(timings, "extract", t0)
    keeps = [model._nms_keep(probi, disti, pointsi, nms_thresh) for probi, disti, pointsi in pre]
    if timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _add_time(timings, "nms", t0)

    def fn(thr):
        prob_thresh = float(np.clip(thr, *bracket))
        value = values.get(prob_thresh)
        if value is None:
            t0 = time.perf_counter()
            Y_instances = []
            for y, (probi, disti, pointsi), keep in zip(Y, pre, keeps):
                n = int(torch.count_nonzero(probi.double() > prob_thresh))
                sel = keep[:n]
                labels, _ = model._render_survivors(
                    y.shape, disti[:n][sel], pointsi[:n][sel], probi[:n][sel])
                Y_instances.append(labels)
            t0 = _add_time(timings, "render", t0)
            stats = matching_dataset(Y, Y_instances, thresh=iou_threshs, show_progress=False,
                                     parallel=True)
            values[prob_thresh] = value = float(np.mean([s._asdict()[measure] for s in stats]))
            _add_time(timings, "matching", t0)
            if timings is not None:
                timings["probes"] = timings.get("probes", 0) + 1
        if verbose > 1:
            now = datetime.datetime.now().strftime("%H:%M:%S")
            print(f"{now}   thresh: {prob_thresh:f}   {measure}: {value:f}", flush=True)
        return -value

    opt = minimize_scalar(fn, method="golden", bracket=bracket, tol=tol,
                          options={"maxiter": maxiter})
    return opt.x, -opt.fun


def polyroi_bytearray(x, y, pos=None, subpixel=True):
    """Byte array of an ImageJ polygon ROI (RoiDecoder format, version 227)."""
    def _i16(v):
        return int(v).to_bytes(2, byteorder="big", signed=True)

    def _u16(v):
        return int(v).to_bytes(2, byteorder="big", signed=False)

    def _i32(v):
        return int(v).to_bytes(4, byteorder="big", signed=True)

    subpixel = bool(subpixel)
    # ImageJ pixel centers are at (0.5, 0.5)
    x_raw = np.asarray(x).ravel() + 0.5
    y_raw = np.asarray(y).ravel() + 0.5
    x = np.round(x_raw)
    y = np.round(y_raw)
    assert len(x) == len(y)
    top, left, bottom, right = y.min(), x.min(), y.max(), x.max()

    n = len(x)
    header = 64
    total = header + n * 4 + subpixel * n * 8
    B = bytearray(total)
    B[0:4] = b"Iout"                      # magic
    B[4:6] = _i16(227)                    # version
    B[6:8] = _i16(0)                      # roi type: polygon
    B[8:10] = _i16(top)
    B[10:12] = _i16(left)
    B[12:14] = _i16(bottom)
    B[14:16] = _i16(right)
    B[16:18] = _u16(n)
    if subpixel:
        B[50:52] = _i16(128)              # subpixel-resolution flag
    if pos is not None:
        B[56:60] = _i32(pos)

    for i, (_x, _y) in enumerate(zip(x, y)):
        xs = header + 2 * i
        ys = xs + 2 * n
        B[xs:xs + 2] = _i16(_x - left)
        B[ys:ys + 2] = _i16(_y - top)

    if subpixel:
        base1 = header + n * 4
        base2 = base1 + n * 4
        for i, (_x, _y) in enumerate(zip(x_raw, y_raw)):
            B[base1 + 4 * i:base1 + 4 * i + 4] = struct.pack(">f", _x)
            B[base2 + 4 * i:base2 + 4 * i + 4] = struct.pack(">f", _y)

    return B


def export_imagej_rois(fname, polygons, set_position=True, subpixel=True,
                       compression=ZIP_DEFLATED):
    """Write polygons (a list of arrays of shape (n, 2, c), e.g. the
    ``coord`` of ``predict_instances``) to an ImageJ ROI zip."""
    if isinstance(polygons, np.ndarray):
        polygons = (polygons,)
    fname = Path(fname)
    if fname.suffix == ".zip":
        fname = fname.with_suffix("")
    with ZipFile(str(fname) + ".zip", mode="w", compression=compression) as roizip:
        for pos, polygroup in enumerate(polygons, start=1):
            for i, poly in enumerate(polygroup, start=1):
                roi = polyroi_bytearray(
                    poly[1], poly[0], pos=(pos if set_position else None), subpixel=subpixel
                )
                roizip.writestr(f"{pos:03d}_{i:03d}.roi", roi)
