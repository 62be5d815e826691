"""Model base: model folder loading and the single-tile prediction pipeline
(counterpart of ``stardist_tpu/models/base.py``).

``predict_instances`` = normalize -> pad -> U-Net forward -> candidate
extraction (threshold, border mask, gather of the candidates' dist columns)
-> greedy NMS -> label rasterization. Everything after the image upload
runs on ``self.device``; only the survivors' arrays and the label image are
copied back.
"""
from __future__ import annotations

import json
import time
import warnings
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

from ..core.axes import axes_check_and_normalize, axes_dict, move_image_axes
from ..core.normalize import NoNormalizer, Normalizer
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


class StarDistBase:
    """Loads ``config.json``, ``thresholds.json`` and the weights of a model
    folder, or builds a model from a config; runs single-tile prediction.

    ``device`` is where the network and every later stage run; it is never
    changed behind the caller's back. ``inference_dtype`` is "bfloat16" (the
    default on CUDA: the conv kernel's type) or "float32" (the default on
    CPU; on CUDA only through the plain convs)."""

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
        if inference_dtype is None:
            inference_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[inference_dtype]
        self.net = StarDistNet(config, dtype=dtype)

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
        if n_tiles is not None and any(int(t) != 1 for t in n_tiles):
            raise NotImplementedError("tiled prediction (n_tiles > 1) is not ported yet")
        axes = self._normalize_axes(img, axes)
        axes_net = self.config.axes
        x = move_image_axes(img, axes, axes_net, adjust_singletons=True)
        channel = axes_dict(axes_net)["C"]
        if self.config.n_channel_in != x.shape[channel]:
            raise ValueError(
                f"expected {self.config.n_channel_in} input channel(s), got {x.shape[channel]}")
        grid_dict = dict(zip(axes_net.replace("C", ""), self.config.grid))
        if normalizer is None:
            normalizer = NoNormalizer()
        if not isinstance(normalizer, Normalizer):
            raise ValueError("normalizer must be a Normalizer instance or None")
        resizer = StarDistPadAndCropResizer(grid=grid_dict)
        x = normalizer.before(x, axes_net)
        x = resizer.before(x, axes_net, self._axes_div_by(axes_net))
        return x, axes_net, resizer

    def _border_key(self, b, x, axes_net, resizer):
        """Per-axis (lo, hi) candidate exclusion in output-grid units: the
        border ``b`` plus the resizer's end padding (the reference's
        ``_device_border_key``)."""
        sp_axes = [a for a in axes_net if a != "C"]
        if np.isscalar(b) or b is None:
            b = ((b, b) if b is not None else (-1, -1),) * len(sp_axes)
        out = []
        for (blo, bhi), a, g, sp in zip(b, sp_axes, self.config.grid,
                                        [s for s, a in zip(x.shape, axes_net) if a != "C"]):
            bound = resizer.padded_shape[a] - resizer.pad[a][1]
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
                       n_tiles=None, b=2, timings=None):
        """Sparse prediction: (prob (K,), dist (K, R), points (K, n_dim))
        tensors on ``self.device``; points in full-resolution pixels."""
        if prob_thresh is None:
            prob_thresh = self.thresholds.prob
        x, axes_net, resizer = self._predict_setup(img, axes, normalizer, n_tiles)
        b_key = self._border_key(b, x, axes_net, resizer)
        t0 = time.perf_counter()
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        prob, dist = self.net(xt)
        _sync(self.device)
        t1 = time.perf_counter()
        vals, d, points = self._extract(prob, dist, float(prob_thresh), b_key)
        points = points * torch.tensor(self.config.grid, device=self.device)[None]
        _sync(self.device)
        if timings is not None:
            timings.update(forward=t1 - t0, extract=time.perf_counter() - t1)
        return vals, d, points

    def predict_instances(self, img, axes=None, normalizer=None, prob_thresh=None,
                          nms_thresh=None, n_tiles=None, b=2, return_labels=True,
                          verbose=False):
        """Predict -> NMS -> rasterize. Returns (labels (*sp) int32 numpy,
        details dict: the survivors (see the model's ``_render_survivors``),
        ``nms_counters`` and the stage times ``timings_s``)."""
        _axes = self._normalize_axes(img, axes)
        x_shape = move_image_axes(img, _axes, self.config.axes, adjust_singletons=True).shape
        shape_inst = tuple(s for s, a in zip(x_shape, self.config.axes) if a != "C")
        timings = {}
        prob, dist, points = self.predict_sparse(
            img, prob_thresh=prob_thresh, axes=axes, normalizer=normalizer,
            n_tiles=n_tiles, b=b, timings=timings)
        labels, details = self._instances_from_prediction(
            shape_inst, prob, dist, points, nms_thresh=nms_thresh,
            return_labels=return_labels, timings=timings, verbose=verbose)
        details["timings_s"] = timings
        return labels, details

    def _instances_from_prediction(self, img_shape, prob, dist, points,
                                   nms_thresh=None, return_labels=True,
                                   timings=None, verbose=False):
        """NMS + rasterization -> (labels, details); reference
        model2d.py:512-563 and model3d.py:314-359 (sparse branch)."""
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
                                                 return_labels=return_labels)
        if timings is not None:
            timings.update(nms=t1 - t0, raster=time.perf_counter() - t1)
        details["nms_counters"] = counters
        return labels, details

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
