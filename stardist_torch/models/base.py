"""Model base: model folder loading and the prediction pipeline
(counterpart of ``stardist_tpu/models/base.py``).

``predict_instances`` = normalize -> pad -> U-Net forward -> candidate
extraction (threshold, border mask, gather of the candidates' dist columns)
-> greedy NMS -> label rasterization. Everything after the image upload
runs on ``self.device``; only the survivors' arrays and the label image are
copied back. With ``n_tiles`` the padded image is cut into overlapping
tiles (``core/tiling.py``); each tile's forward and extraction run in turn
and the candidate lists are joined in tile order. ``predict`` is the dense
prediction (prob and dist maps as numpy).
"""
from __future__ import annotations

import json
import math
import time
import warnings
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

from ..core.axes import axes_check_and_normalize, axes_dict, move_image_axes
from ..core.normalize import NoNormalizer, Normalizer
from ..core.tiling import tile_iterator
from ..utils import _is_power_of_2
from .unet import StarDistNet
from .weights import load_flax_checkpoint, params_from_flax


class StarDistPadAndCropResizer:
    """Pads the input at the end to network divisibility and filters
    candidate points that fall into the padding (reference base.py:1162-1211)."""

    def __init__(self, grid, mode="reflect", **kwargs):
        assert isinstance(grid, dict)
        self.mode = mode
        self.grid = grid
        self.kwargs = kwargs

    def before(self, x, axes, axes_div_by):
        assert all(a % g == 0 for g, a in zip((self.grid.get(a, 1) for a in axes), axes_div_by))
        axes = axes_check_and_normalize(axes, x.ndim)
        self.pad = {
            a: (0, (div_n - s % div_n) % div_n)
            for a, div_n, s in zip(axes, axes_div_by, x.shape)
        }
        x_pad = np.pad(x, tuple(self.pad[a] for a in axes), mode=self.mode, **self.kwargs)
        self.padded_shape = dict(zip(axes, x_pad.shape))
        self.padded_shape.pop("C", None)
        return x_pad

    def after(self, x, axes):
        """Crop the end padding off an output of grid-subsampled shape."""
        axes = axes_check_and_normalize(axes, x.ndim)
        assert all(
            s_pad == s * g
            for s, s_pad, g in zip(
                x.shape,
                (self.padded_shape.get(a, _s) for a, _s in zip(axes, x.shape)),
                (self.grid.get(a, 1) for a in axes),
            )
        )
        crop = tuple(
            slice(0, -(math.floor(p[1] / g)) if p[1] >= g else None)
            for p, g in zip(
                (self.pad.get(a, (0, 0)) for a in axes),
                (self.grid.get(a, 1) for a in axes),
            )
        )
        return x[crop]

    def filter_points(self, ndim, points, axes):
        """Indices of points located inside the unpadded region."""
        assert points.ndim == 2
        axes = axes_check_and_normalize(axes, ndim)
        bounds = np.array(tuple(
            self.padded_shape[a] - self.pad[a][1]
            for a in axes if a.lower() in ("z", "y", "x")
        ))
        return np.where(np.all(points < bounds, 1))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _receptive_field(net, img_size, config, device):
    """(before, after) extent per spatial axis of the pixels whose prob
    changes when one input pixel in the middle of ``img_size`` is set to 1,
    or None when none changes."""
    from scipy.ndimage import zoom
    mid = tuple(s // 2 for s in img_size)
    x = np.zeros(img_size + (config.n_channel_in,), np.float32)
    x[mid] = 1
    y = net(torch.from_numpy(x).to(device))[0].cpu().numpy()
    y0 = net(torch.zeros_like(torch.from_numpy(x)).to(device))[0].cpu().numpy()
    grid = tuple((np.array(img_size) / np.array(y.shape)).astype(int))
    assert grid == tuple(config.grid)
    ind = np.where(np.abs(zoom(y, grid, order=0) - zoom(y0, grid, order=0)) > 0)
    if any(len(i) == 0 for i in ind):
        return None
    return [(m - int(np.min(i)), int(np.max(i)) - m) for m, i in zip(mid, ind)]


class StarDistBase:
    """Loads ``config.json``, ``thresholds.json`` and the weights of a model
    folder, or builds a model from a config; runs single-tile prediction.

    ``device`` is where the network and every later stage run; it is never
    changed behind the caller's back. ``inference_dtype`` is "bfloat16" (the
    default on CUDA: the conv kernel's type) or "float32" (the default on
    CPU); see :meth:`set_inference_precision`."""

    def __init__(self, config=None, name=None, basedir=".", device="cuda",
                 inference_dtype=None):
        self.device = torch.device(device)
        self.basedir = Path(basedir) if basedir is not None else None
        loading = config is None
        if loading:
            if self.basedir is None or name is None:
                raise ValueError("config=None requires 'name' and 'basedir' to load a saved model")
            cfg_path = self.basedir / name / "config.json"
            if not cfg_path.exists():
                raise FileNotFoundError(f"config file doesn't exist: {cfg_path}")
            with open(cfg_path) as f:
                config = self._config_class(**json.load(f))
        self.config = config
        self.name = name
        self.net = StarDistNet(config)
        if inference_dtype is None:
            inference_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        self.set_inference_precision(inference_dtype)

        if loading:
            weights = self._weights_file()
            if weights is None:
                warnings.warn(f"no network weights found in {self.logdir}")
            else:
                self.load_weights(weights)
        threshs = {}
        if self.basedir is not None and name is not None:
            try:
                with open(self.logdir / "thresholds.json") as f:
                    threshs = json.load(f)
            except FileNotFoundError:
                pass
        prob = threshs.get("prob")
        nms = threshs.get("nms")
        self.thresholds = namedtuple("Thresholds", ("prob", "nms"))(
            prob=prob if prob is not None and 0 < prob < 1 else 0.5,
            nms=nms if nms is not None and 0 < nms < 1 else 0.4)
        self.net.to(self.device)

    def set_inference_precision(self, dtype):
        """``dtype``: None or "float32" (full precision) or "bfloat16"
        (reference base.py:1101-1106). A float32 net runs every conv through
        its plain PyTorch version, on CUDA too: that is the float32 route,
        taken from the net's type (``StarDistNet.forward``); the conv kernels
        take bfloat16 only. On CUDA those convs follow PyTorch's TF32 switch,
        ``torch.backends.cudnn.allow_tf32``."""
        if dtype == "float32":
            dtype = None
        if dtype not in (None, "bfloat16"):
            raise ValueError(f"inference precision must be None, 'float32' or 'bfloat16', "
                             f"got {dtype!r}")
        self.inference_dtype = dtype
        self.net.dtype = torch.float32 if dtype is None else torch.bfloat16

    @property
    def logdir(self):
        return self.basedir / self.name

    def _weights_file(self, prefer="best"):
        files = [f for ext in ("*.h5", "*.hdf5", "*.msgpack", "*.weights")
                 for f in sorted(self.logdir.glob(ext)) if f.is_file()]
        if not files:
            return None
        return ([f for f in files if prefer in f.name] + files)[0]

    def load_weights(self, path):
        """Load a flax msgpack checkpoint (the reference's ``.h5`` files)."""
        path = Path(path)
        if path.read_bytes()[:4] == b"\x89HDF":
            raise NotImplementedError("Keras HDF5 import is not ported yet")
        sd = params_from_flax(self.net, load_flax_checkpoint(path))
        self.net.load_state_dict(sd)
        self.net.to(self.device)

    # -- prediction -----------------------------------------------------------

    def _normalize_axes(self, img, axes):
        if axes is None:
            axes = self.config.axes
            assert "C" in axes
            if img.ndim == len(axes) - 1 and self.config.n_channel_in == 1:
                axes = axes.replace("C", "")
        return axes_check_and_normalize(axes, img.ndim)

    def _predict_setup(self, img, axes, normalizer, n_tiles):
        """Normalized, padded network input ``x`` (axes ``axes_net``), the
        resizer, and ``n_tiles`` in ``axes_net`` order (reference
        base.py:1259-1323)."""
        if n_tiles is None:
            n_tiles = [1] * img.ndim
        try:
            n_tiles = tuple(n_tiles)
            if img.ndim != len(n_tiles):
                raise TypeError()
        except TypeError:
            raise ValueError(f"n_tiles must be an iterable of length {img.ndim}")
        if not all(np.isscalar(t) and 1 <= t and int(t) == t for t in n_tiles):
            raise ValueError("all values of n_tiles must be integer values >= 1")
        n_tiles = tuple(map(int, n_tiles))
        axes = self._normalize_axes(img, axes)
        axes_net = self.config.axes
        x = move_image_axes(img, axes, axes_net, adjust_singletons=True)
        channel = axes_dict(axes_net)["C"]
        if self.config.n_channel_in != x.shape[channel]:
            raise ValueError(
                f"expected {self.config.n_channel_in} input channel(s), got {x.shape[channel]}")
        n_tiles = move_image_axes(np.empty(n_tiles, bool), axes, axes_net,
                                  adjust_singletons=True).shape
        if n_tiles[channel] != 1:
            raise ValueError(f"entry of n_tiles > 1 only allowed for axes "
                             f"'{axes_net.replace('C', '')}'")
        grid_dict = dict(zip(axes_net.replace("C", ""), self.config.grid))
        if normalizer is None:
            normalizer = NoNormalizer()
        if not isinstance(normalizer, Normalizer):
            raise ValueError("normalizer must be a Normalizer instance or None")
        resizer = StarDistPadAndCropResizer(grid=grid_dict)
        x = normalizer.before(x, axes_net)
        x = resizer.before(x, axes_net, self._axes_div_by(axes_net))
        return x, axes_net, resizer, n_tiles

    def _tiles(self, x, axes_net, n_tiles):
        """Overlapping tiles of ``x``: (tile, s_src, s_dst) with the slices in
        output-grid units (the channel axis whole); the overlap is the
        network's receptive field in whole blocks of the network stride
        (``tiling_setup`` of reference base.py:1296-1320)."""
        div_by = self._axes_div_by(axes_net)
        n_block_overlaps = [int(np.ceil(o / b))
                            for o, b in zip(self._axes_tile_overlap(axes_net), div_by)]
        grid_dict = dict(zip(axes_net.replace("C", ""), self.config.grid))

        def to_grid(sl):
            return tuple(slice(None) if a == "C" else
                         slice(s.start // grid_dict[a], s.stop // grid_dict[a])
                         for s, a in zip(sl, axes_net))

        for tile, s_src, s_dst in tile_iterator(x, n_tiles, block_sizes=div_by,
                                                n_block_overlaps=n_block_overlaps,
                                                equal_tiles=True):
            yield tile, to_grid(s_src), to_grid(s_dst)

    def _prestaged(self, img, axes, normalizer, n_tiles):
        """A pre-staged input tensor, checked as the reference's device path
        checks it (model2d.py:514-535): on ``self.device``, already
        normalized, in the model's own axes (``(sp..., C)``, C may be left
        out when it is 1), each spatial size divisible by the network
        stride, one tile. Returns it as ``(sp..., C)``."""
        sp_axes = self.config.axes.replace("C", "")
        if normalizer is not None or axes not in (None, sp_axes, sp_axes + "C"):
            raise ValueError("tensor input must be pre-normalized with default axes")
        if n_tiles is not None and np.prod(n_tiles) > 1:
            raise ValueError("tensor input is predicted in one tile")
        dev = self.device
        if dev.type == "cuda" and dev.index is None:    # "cuda" is the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        if img.device != dev:
            raise ValueError(f"tensor input on {img.device}, the model on {self.device}")
        x = img[..., None] if img.dim() == len(sp_axes) else img
        if x.dim() != len(sp_axes) + 1 or x.shape[-1] != self.config.n_channel_in:
            raise ValueError(f"expected ({', '.join(sp_axes)}[, C={self.config.n_channel_in}]) "
                             f"input")
        div_by = self._axes_div_by(sp_axes)
        if any(s % d for s, d in zip(x.shape, div_by)):
            raise ValueError(f"tensor input spatial dims must be divisible by {div_by}")
        return x

    def _upload(self, x):
        """numpy input -> float32 tensor on ``self.device``; a pre-staged
        tensor is already there."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _border_key(self, b, x, axes_net, resizer):
        """Per-axis (lo, hi) candidate exclusion in output-grid units: the
        border ``b`` plus the resizer's end padding (the reference's
        ``_device_border_key``; a pre-staged tensor has no resizer and no
        padding)."""
        sp_axes = [a for a in axes_net if a != "C"]
        if np.isscalar(b) or b is None:
            b = ((b, b) if b is not None else (-1, -1),) * len(sp_axes)
        out = []
        for (blo, bhi), a, g, sp in zip(b, sp_axes, self.config.grid,
                                        [s for s, a in zip(x.shape, axes_net) if a != "C"]):
            bound = sp if resizer is None else resizer.padded_shape[a] - resizer.pad[a][1]
            ub_grid = (bound - 1) // g + 1
            out.append((blo, max(bhi if bhi is not None and bhi > 0 else 0, sp // g - ub_grid)))
        return tuple(out)

    @staticmethod
    def _extract(prob, dist, prob_thresh, b_key):
        """Candidates above ``prob_thresh`` and inside the border: (prob (K,),
        dist (K, R) clamped at 1e-3, points (K, n_dim) in output-grid units).

        The list comes in the reference's ``lax.top_k`` order: descending
        prob, ties in ascending flat index. The NMS then sorts it with
        :func:`..nms.descending_order`, which puts ties in descending flat
        index, as the reference's ``np.argsort(prob, kind="stable")[::-1]``
        does on the same list."""
        mask = prob > prob_thresh
        for ax, (blo, bhi) in enumerate(b_key):
            sl = [slice(None)] * prob.dim()
            if blo > 0:
                sl[ax] = slice(0, blo)
                mask[tuple(sl)] = False
            if bhi > 0:
                sl[ax] = slice(prob.shape[ax] - bhi, None)
                mask[tuple(sl)] = False
        idx = torch.nonzero(mask.flatten()).flatten()
        vals = prob.flatten()[idx]
        order = torch.sort(vals, descending=True, stable=True).indices
        idx, vals = idx[order], vals[order]
        d = dist.reshape(dist.shape[0], -1)[:, idx].t().clamp_min(1e-3)
        coords, rest = [], idx
        for s in reversed(prob.shape):
            coords.append(rest % s)
            rest = rest // s
        points = torch.stack(coords[::-1], dim=1)
        return vals, d, points

    def predict_sparse(self, img, prob_thresh=None, axes=None, normalizer=None,
                       n_tiles=None, show_tile_progress=True, b=2, max_candidates=None,
                       device_dist=False):
        """Sparse prediction (reference base.py:1375-1477): numpy (prob (K,)
        float32, dist (K, R) float32, points (K, n_dim) int64), points in
        full-resolution pixels; see :meth:`_predict_sparse`.
        ``show_tile_progress`` shows nothing, as in the reference;
        ``max_candidates`` and ``device_dist`` are not ported."""
        if max_candidates is not None:
            raise NotImplementedError("predict_sparse(max_candidates=...) is not ported yet")
        if device_dist:
            raise NotImplementedError("predict_sparse(device_dist=True) is not ported: "
                                      "predict_instances keeps the candidates on the device")
        return tuple(t.cpu().numpy() for t in self._predict_sparse(
            img, prob_thresh, axes, normalizer, n_tiles, b))

    def _predict_sparse(self, img, prob_thresh=None, axes=None, normalizer=None,
                        n_tiles=None, b=2, timings=None):
        """Sparse prediction: (prob (K,), dist (K, R), points (K, n_dim))
        tensors on ``self.device``; points in full-resolution pixels.

        ``img`` is a numpy image, or a pre-staged tensor on ``self.device``
        (see :meth:`_prestaged`). With ``n_tiles`` (one count per axis of
        ``img``) each tile's candidates are those of its core, minus the
        border ``b`` at the image's edges; the lists are joined in tile
        order, each in its tile's ``top_k`` order (reference
        base.py:1395-1432), and candidates in the padding are dropped."""
        if prob_thresh is None:
            prob_thresh = self.thresholds.prob
        if isinstance(img, torch.Tensor):
            x = self._prestaged(img, axes, normalizer, n_tiles)
            axes_net, resizer, n_tiles = self.config.axes, None, (1,) * x.dim()
        else:
            x, axes_net, resizer, n_tiles = self._predict_setup(img, axes, normalizer, n_tiles)
        grid = torch.tensor(self.config.grid, device=self.device)
        t_fwd = t_ext = 0.0
        if np.prod(n_tiles) > 1:
            sp = [i for i, a in enumerate(axes_net) if a != "C"]
            out_sh = [x.shape[i] // g for i, g in zip(sp, self.config.grid)]
            bb = 0 if b is None else b
            parts = []
            for tile, s_src, s_dst in self._tiles(x, axes_net, n_tiles):
                s_src = [s_src[i] for i in sp]
                s_dst = [s_dst[i] for i in sp]
                t0 = time.perf_counter()
                prob, dist = self.net(self._upload(tile))
                _sync(self.device)
                t1 = time.perf_counter()
                b_key = tuple((s_s.start + (bb if s_d.start == 0 else 0),
                               (t_len - s_s.stop) + (bb if s_d.stop == sh else 0))
                              for s_s, s_d, t_len, sh in zip(s_src, s_dst, prob.shape, out_sh))
                vals, d, points = self._extract(prob, dist, float(prob_thresh), b_key)
                offset = torch.tensor([s_d.start - s_s.start for s_s, s_d in zip(s_src, s_dst)],
                                      device=self.device)
                parts.append((vals, d, (points + offset) * grid))
                _sync(self.device)
                t_fwd += t1 - t0
                t_ext += time.perf_counter() - t1
            t1 = time.perf_counter()
            vals, d, points = (torch.cat(t) for t in zip(*parts))
            bounds = torch.tensor([resizer.padded_shape[a] - resizer.pad[a][1]
                                   for a in axes_net if a != "C"], device=self.device)
            inside = torch.all(points < bounds, dim=1)
            vals, d, points = vals[inside], d[inside], points[inside]
            _sync(self.device)
            t_ext += time.perf_counter() - t1
        else:
            b_key = self._border_key(b, x, axes_net, resizer)
            t0 = time.perf_counter()
            prob, dist = self.net(self._upload(x))
            _sync(self.device)
            t1 = time.perf_counter()
            vals, d, points = self._extract(prob, dist, float(prob_thresh), b_key)
            points = points * grid[None]
            _sync(self.device)
            t_fwd, t_ext = t1 - t0, time.perf_counter() - t1
        if timings is not None:
            timings.update(forward=t_fwd, extract=t_ext)
        return vals, d, points

    def predict(self, img, axes=None, normalizer=None, n_tiles=None, show_tile_progress=True):
        """Dense prediction (reference base.py:1325-1373): prob (sp/g...) and
        dist (sp/g..., R), numpy float32, on the grid of the network output
        and cropped to the image; dist clamped at 1e-3. ``show_tile_progress``
        is taken so that calls written for the reference run; it shows
        nothing, as in the reference."""
        x, axes_net, resizer, n_tiles = self._predict_setup(img, axes, normalizer, n_tiles)
        channel = axes_dict(axes_net)["C"]
        if np.prod(n_tiles) > 1:
            grid_dict = dict(zip(axes_net.replace("C", ""), self.config.grid))
            sh = [s // grid_dict.get(a, 1) for a, s in zip(axes_net, x.shape)]
            result = []
            for n_ch in (1, self.config.n_rays):
                sh[channel] = n_ch
                result.append(np.empty(sh, np.float32))
            for tile, s_src, s_dst in self._tiles(x, axes_net, n_tiles):
                for part, part_tile in zip(result, self._forward_np(tile)):
                    part[s_dst] = part_tile[s_src]
        else:
            result = self._forward_np(x)
        prob, dist = (resizer.after(part, axes_net) for part in result)
        prob = np.take(prob, 0, axis=channel)
        dist = np.moveaxis(np.maximum(1e-3, dist), channel, -1)
        return prob, dist

    def _forward_np(self, x):
        """Forward of one (sp..., C) numpy input -> channels-last numpy
        (prob (sp'..., 1), dist (sp'..., R))."""
        prob, dist = self.net(self._upload(x))
        return prob.cpu().numpy()[..., None], np.moveaxis(dist.cpu().numpy(), 0, -1)

    def predict_instances(self, img, axes=None, normalizer=None, sparse=True, prob_thresh=None,
                          nms_thresh=None, scale=None, n_tiles=None, show_tile_progress=True,
                          verbose=False, return_labels=True, predict_kwargs=None,
                          nms_kwargs=None, overlap_label=None, return_predict=False, *, b=2):
        """Predict -> NMS -> rasterize, with the reference's parameters
        (base.py:1479-1571). Returns (labels (*sp) int32 numpy, details
        dict: the survivors (see the model's ``_render_survivors``),
        ``nms_counters`` and the stage times ``timings_s``). ``img`` and
        ``n_tiles`` as in :meth:`_predict_sparse`; ``show_tile_progress`` as
        in :meth:`predict`; ``b`` is the candidates' border. The parameters
        that would change the result and are not ported yet raise
        ``NotImplementedError`` when set: ``sparse=False``, ``scale``,
        ``predict_kwargs``, ``nms_kwargs``, ``overlap_label`` and
        ``return_predict``."""
        unported = {"sparse": not sparse, "scale": scale is not None,
                    "predict_kwargs": bool(predict_kwargs), "nms_kwargs": bool(nms_kwargs),
                    "overlap_label": overlap_label is not None, "return_predict": return_predict}
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(f"predict_instances({name}=...) is not ported yet")
        return self._predict_instances(img, axes, normalizer, prob_thresh, nms_thresh,
                                       n_tiles, b, return_labels, verbose)

    def _predict_instances(self, img, axes, normalizer, prob_thresh, nms_thresh, n_tiles,
                           b, return_labels, verbose, **render_kw):
        """:meth:`predict_instances`; ``render_kw`` goes to the model's
        ``_render_survivors``."""
        if isinstance(img, torch.Tensor):
            shape_inst = tuple(int(s) for s in img.shape[:self.config.n_dim])
        else:
            _axes = self._normalize_axes(img, axes)
            x_shape = move_image_axes(img, _axes, self.config.axes, adjust_singletons=True).shape
            shape_inst = tuple(s for s, a in zip(x_shape, self.config.axes) if a != "C")
        timings = {}
        prob, dist, points = self._predict_sparse(
            img, prob_thresh=prob_thresh, axes=axes, normalizer=normalizer,
            n_tiles=n_tiles, b=b, timings=timings)
        labels, details = self._instances_from_prediction(
            shape_inst, prob, dist, points, nms_thresh=nms_thresh,
            return_labels=return_labels, timings=timings, verbose=verbose, **render_kw)
        details["timings_s"] = timings
        return labels, details

    def _instances_from_prediction(self, img_shape, prob, dist, points,
                                   nms_thresh=None, return_labels=True,
                                   timings=None, verbose=False, **render_kw):
        """NMS + rasterization -> (labels, details); reference
        model2d.py:512-563 and model3d.py:314-359 (sparse branch).
        ``timings["raster"]`` includes the copy back to the host."""
        if nms_thresh is None:
            nms_thresh = self.thresholds.nms
        counters = {}
        t0 = time.perf_counter()
        points, probi, disti = self._nms_sparse(
            dist, prob, points, nms_thresh=nms_thresh, verbose=verbose,
            stats=counters)[:3]
        _sync(self.device)
        t1 = time.perf_counter()
        labels, details = self._render_survivors(img_shape, disti, points, probi,
                                                 return_labels=return_labels, **render_kw)
        if timings is not None:
            timings.update(nms=t1 - t0, raster=time.perf_counter() - t1)
        details["nms_counters"] = counters
        return labels, details

    def _guess_n_tiles(self, img):
        """Tile counts that cut ``img`` into about training-batch-sized
        tiles (reference base.py:1693-1702)."""
        axes = self._normalize_axes(img, axes=None)
        shape = list(img.shape)
        if "C" in axes:
            del shape[axes_dict(axes)["C"]]
        b = self.config.train_batch_size ** (1.0 / self.config.n_dim)
        n_tiles = [int(np.ceil(s / (p * b))) for s, p in zip(shape, self.config.train_patch_size)]
        if "C" in axes:
            n_tiles.insert(axes_dict(axes)["C"], 1)
        return tuple(n_tiles)

    def _compute_receptive_field(self, img_size=None):
        """Empirical receptive field: a delta image through the network,
        (before, after) the delta per spatial axis (reference
        base.py:1704-1730). A net whose output ignores the delta (e.g. the
        zero weights of a model built from a config) is replaced by a
        freshly initialised one (seeded)."""
        if img_size is None:
            img_size = tuple(g * (128 if self.config.n_dim == 2 else 64) for g in self.config.grid)
        if np.isscalar(img_size):
            img_size = (img_size,) * self.config.n_dim
        img_size = tuple(img_size)
        assert all(_is_power_of_2(s) for s in img_size)
        rf = _receptive_field(self.net, img_size, self.config, self.device)
        if rf is None:
            fresh = StarDistNet(self.config, dtype=self.net.dtype)
            fresh.init_weights(torch.Generator().manual_seed(0))
            rf = _receptive_field(fresh.to(self.device), img_size, self.config, self.device)
        return rf

    def _axes_tile_overlap(self, query_axes):
        """Tile overlap per axis of ``query_axes``: the larger side of the
        receptive field (reference base.py:1732-1742)."""
        query_axes = axes_check_and_normalize(query_axes)
        if getattr(self, "_tile_overlap", None) is None:
            self._tile_overlap = self._compute_receptive_field()
        overlap = dict(zip(self.config.axes.replace("C", ""),
                           tuple(max(rf) for rf in self._tile_overlap)))
        return tuple(overlap.get(a, 0) for a in query_axes)

    def _axes_div_by(self, query_axes):
        query_axes = axes_check_and_normalize(query_axes)
        div_by = dict(zip(
            self.config.axes.replace("C", ""),
            tuple(p ** self.config.unet_n_depth * g
                  for p, g in zip(self.config.unet_pool, self.config.grid)),
        ))
        return tuple(div_by.get(a, 1) for a in query_axes)

    @property
    def _config_class(self):
        raise NotImplementedError()

    def _nms_sparse(self, dist, prob, points, nms_thresh, verbose, stats):
        raise NotImplementedError()

    def _render_survivors(self, img_shape, disti, points, probi, return_labels=True):
        raise NotImplementedError()
