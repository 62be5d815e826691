"""3D StarDist model (counterpart of ``stardist_tpu/models/model3d.py``):
the config, the training data and targets, training, and prediction."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.axes import axes_check_and_normalize
from ..core.config import BaseConfig
from ..core.profiling import span
from ..geometry import polyhedron_to_label
from ..nms import (non_maximum_suppression_3d, non_maximum_suppression_3d_inds,
                   non_maximum_suppression_3d_sparse)
from ..ops.edt import edt_prob_batch
from ..ops.stardist3d import _default_max_dist, march_steps, star_dist3d
from ..rays3d import Rays_GoldenSpiral, rays_from_json
from ..sample_patches import sample_patches
from ..utils import _normalize_grid, as_tensor_on, edt_prob
from .base import StarDistBase, StarDistDataBase, _class_details
from .model2d import _as_batch_dict, _BatchDictAdapter, class_targets


DEVICE_LATTICE_S = 10  # the 3D device path's lattice (reference model3d.py:554)


class StarDistData3D(StarDistDataBase):
    """Training batches (reference model3d.py:27-103): random
    foreground-biased patches -> augmenter -> targets. ``__getitem__``
    builds the targets on the host (scipy EDT prob with ``anisotropy`` at
    full resolution, then subsampled by the grid; the star distances on
    ``device``: the card unless the caller passes ``device="cpu"``; with
    ``n_classes`` the class maps of ``classes``), as the validation batch
    and multiclass training need; :meth:`raw_item` leaves them to the
    training step."""

    def __init__(self, X, Y, batch_size, rays, length, n_classes=None, classes=None,
                 patch_size=(128, 128, 128), grid=(1, 1, 1), anisotropy=None,
                 augmenter=None, foreground_prob=0, device="cuda", **kwargs):
        super().__init__(X=X, Y=Y, n_rays=len(rays), grid=grid,
                         n_classes=n_classes, classes=classes,
                         batch_size=batch_size, patch_size=patch_size, length=length,
                         augmenter=augmenter, foreground_prob=foreground_prob, **kwargs)
        self.rays = rays
        self.anisotropy = anisotropy
        self.device = torch.device(device)

    def _sample_batch(self, i):
        """Shared host prefix: foreground-biased patch sampling + augmentation."""
        idx = self.batch(i)
        arrays = [
            sample_patches((self.Y[k],) + self.channels_as_tuple(self.X[k]),
                           patch_size=self.patch_size, n_samples=1,
                           valid_inds=self.get_valid_inds(k))
            for k in idx
        ]
        if self.n_channel is None:
            X, Y = list(zip(*[(x[0], y[0]) for y, x in arrays]))
        else:
            X, Y = list(zip(*[
                (np.stack([_x[0] for _x in x], axis=-1), y[0]) for y, *x in arrays
            ]))
        X, Y = tuple(zip(*tuple(self.augmenter(_x, _y) for _x, _y in zip(X, Y))))
        return idx, X, Y

    def raw_item(self, i):
        """The raw batch (see :meth:`StarDistDataBase.raw_item`) and
        ``steps``, the star-distance march's bound for its labels."""
        raw = super().raw_item(i)
        raw["steps"] = march_steps(raw["y"], self.rays)
        return raw

    def __getitem__(self, i):
        idx, X, Y = self._sample_batch(i)

        mask_neg_labels = tuple(y[self.ss_grid[1:4]] < 0 for y in Y)
        has_neg_labels = any(m.any() for m in mask_neg_labels)
        if has_neg_labels:
            mask_neg_labels = np.stack(mask_neg_labels)
            Y = tuple(np.maximum(y, 0) for y in Y)

        # the EDT at full resolution, then subsampled (reference model3d.py:70-74)
        prob = np.stack([edt_prob(lbl, anisotropy=self.anisotropy)[self.ss_grid[1:4]]
                         for lbl in Y])
        lbls = np.stack(Y).astype(np.int32)
        dist = star_dist3d(torch.from_numpy(lbls).to(self.device), self.rays, self.grid,
                           n_steps=march_steps(lbls, self.rays)).cpu().numpy()

        X = np.stack(X)
        if X.ndim == 4:  # no channel axis
            X = np.expand_dims(X, -1)
        prob = np.expand_dims(prob, -1)

        # the dist target carries the mask (the prob) as an extra last channel
        dist_and_mask = np.empty(dist.shape[:-1] + (self.n_rays + 1,), np.float32)
        dist_and_mask[..., :-1] = dist
        dist_and_mask[..., -1:] = prob

        if has_neg_labels:
            prob[mask_neg_labels] = -1  # disables the loss at these voxels
        if self.n_classes is None:
            return (X,), (prob, dist_and_mask)
        prob_class = class_targets(Y, idx, self.classes, self.n_classes, self.grid)
        if has_neg_labels:
            prob_class[mask_neg_labels] = -1
        return (X,), (prob, dist_and_mask, prob_class)


class Config3D(BaseConfig):
    """Configuration for StarDist3D; the same keys, defaults and config.json
    schema as ``stardist_tpu.models.model3d.Config3D`` (the rays are kept
    as their JSON description, ``rays_json``)."""

    def __init__(self, axes="ZYX", rays=None, n_channel_in=1, grid=(1, 1, 1),
                 n_classes=None, anisotropy=None, backbone="unet", **kwargs):
        if rays is None:
            if "rays_json" in kwargs:
                rays = rays_from_json(kwargs["rays_json"])
            elif "n_rays" in kwargs:
                rays = Rays_GoldenSpiral(kwargs["n_rays"])
            else:
                rays = Rays_GoldenSpiral(96)
        elif np.isscalar(rays):
            rays = Rays_GoldenSpiral(rays)

        super().__init__(axes=axes, n_channel_in=n_channel_in, n_channel_out=1 + len(rays))

        self.n_rays = len(rays)
        self.grid = _normalize_grid(grid, 3)
        self.anisotropy = anisotropy if anisotropy is None else tuple(anisotropy)
        self.backbone = str(backbone).lower()
        self.rays_json = rays.to_json()
        self.n_classes = None if n_classes is None else int(n_classes)

        if "anisotropy" in self.rays_json["kwargs"]:
            if self.rays_json["kwargs"]["anisotropy"] is None and self.anisotropy is not None:
                self.rays_json["kwargs"]["anisotropy"] = self.anisotropy
                print("Changing 'anisotropy' of rays to %s" % str(anisotropy))
            elif self.rays_json["kwargs"]["anisotropy"] != self.anisotropy:
                warnings.warn("Mismatch of 'anisotropy' of rays and 'anisotropy'.")

        if self.backbone == "unet":
            self.unet_n_depth = 2
            self.unet_kernel_size = 3, 3, 3
            self.unet_n_filter_base = 32
            self.unet_n_conv_per_depth = 2
            self.unet_pool = 2, 2, 2
            self.unet_activation = "relu"
            self.unet_last_activation = "relu"
            self.unet_batch_norm = False
            self.unet_dropout = 0.0
            self.unet_prefix = ""
            self.net_conv_after_unet = 128
        elif self.backbone == "resnet":
            self.resnet_n_blocks = 4
            self.resnet_kernel_size = 3, 3, 3
            self.resnet_kernel_init = "he_normal"
            self.resnet_n_filter_base = 32
            self.resnet_n_conv_per_block = 3
            self.resnet_activation = "relu"
            self.resnet_batch_norm = False
            self.net_conv_after_resnet = 128
        else:
            raise ValueError("backbone '%s' not supported." % self.backbone)

        self.net_input_shape = None, None, None, self.n_channel_in
        self.net_mask_shape = None, None, None, 1

        self.train_patch_size = 128, 128, 128
        self.train_background_reg = 1e-4
        self.train_foreground_only = 0.9
        self.train_sample_cache = True

        self.train_dist_loss = "mae"
        self.train_loss_weights = (1, 0.2) if self.n_classes is None else (1, 0.2, 1)
        self.train_class_weights = (1, 1) if self.n_classes is None else (1,) * (self.n_classes + 1)
        self.train_epochs = 400
        self.train_steps_per_epoch = 100
        self.train_learning_rate = 0.0003
        self.train_batch_size = 1
        self.train_n_val_patches = None
        self.train_tensorboard = True
        self.train_reduce_lr = {"factor": 0.5, "patience": 40, "min_delta": 0}

        self.use_gpu = False

        for k in ("n_dim", "n_channel_out", "n_rays", "rays_json"):
            kwargs.pop(k, None)

        self.update_parameters(False, **kwargs)

        if not len(self.train_loss_weights) == (2 if self.n_classes is None else 3):
            raise ValueError(
                f"train_loss_weights {self.train_loss_weights} not compatible with "
                f"n_classes ({self.n_classes})")
        if not len(self.train_class_weights) == (2 if self.n_classes is None else self.n_classes + 1):
            raise ValueError(
                f"train_class_weights {self.train_class_weights} not compatible with "
                f"n_classes ({self.n_classes})")


class StarDist3D(StarDistBase):
    """3D StarDist model (U-Net or ResNet backbone): training and the
    instance-prediction pipeline.

    ``StarDist3D(None, name, basedir)`` loads a saved model folder
    (``config.json``, ``thresholds.json``, ``weights_best.h5``);
    ``StarDist3D(Config3D(...), name, basedir, device=...)`` builds one with
    seeded random weights (see ``net.init_weights``) and, with a
    ``basedir``, writes its ``config.json``."""

    @property
    def rays(self):
        return rays_from_json(self.config.rays_json)

    def train(self, X, Y, validation_data, classes="auto", augmenter=None, seed=None,
              epochs=None, steps_per_epoch=None, workers=1, resume=False):
        """Train the network on ``self.device`` (reference model3d.py:208-271),
        as :meth:`StarDist2D.train` does: negative label values disable all
        losses at those voxels; ``resume=True`` continues from the last
        epoch's ``train_state.pt``; ``workers`` is taken for the reference's
        signature. Returns the :class:`History`."""
        if seed is not None:
            np.random.seed(seed)
        if epochs is None:
            epochs = self.config.train_epochs
        if steps_per_epoch is None:
            steps_per_epoch = self.config.train_steps_per_epoch

        classes = self._parse_classes_arg(classes, len(X))
        if not self._is_multiclass() and classes is not None:
            warnings.warn("Ignoring given classes as n_classes is set to None")

        if not isinstance(validation_data, (list, tuple)):
            raise ValueError("validation_data must be a tuple/list")
        if self._is_multiclass() and len(validation_data) == 2:
            validation_data = tuple(validation_data) + ("auto",)
        if len(validation_data) != (3 if self._is_multiclass() else 2):
            raise ValueError(
                f"len(validation_data) = {len(validation_data)}, but should be "
                f"{3 if self._is_multiclass() else 2}")

        patch_size = self.config.train_patch_size
        axes = self.config.axes.replace("C", "")
        div_by = self._axes_div_by(axes)
        for p, d, a in zip(patch_size, div_by, axes):
            if p % d != 0:
                raise ValueError(f"'train_patch_size' must be divisible by {d} along axis '{a}'")

        if not self._model_prepared:
            self.prepare_for_training()

        data_kwargs = dict(
            rays=self.rays,
            grid=self.config.grid,
            patch_size=self.config.train_patch_size,
            anisotropy=self.config.anisotropy,
            use_gpu=self.config.use_gpu,
            foreground_prob=self.config.train_foreground_only,
            n_classes=self.config.n_classes,
            sample_ind_cache=self.config.train_sample_cache,
            device=self.device,
        )

        n_data_val = len(validation_data[0])
        classes_val = self._parse_classes_arg(validation_data[2], n_data_val) \
            if self._is_multiclass() else None
        n_take = self.config.train_n_val_patches if self.config.train_n_val_patches is not None else n_data_val
        _data_val = StarDistData3D(validation_data[0], validation_data[1], classes=classes_val,
                                   batch_size=n_take, length=1, **data_kwargs)
        data_val = _data_val[0]

        self.data_train = StarDistData3D(X, Y, classes=classes,
                                         batch_size=self.config.train_batch_size,
                                         augmenter=augmenter,
                                         length=epochs * steps_per_epoch, **data_kwargs)

        val_batch = _as_batch_dict(data_val)
        use_raw = self._targets_fn is not None and self.data_train.supports_raw
        train_data = _BatchDictAdapter(self.data_train, raw=use_raw)
        return self._fit(train_data, val_batch, epochs, steps_per_epoch, resume=resume)

    def _device_targets_fn(self):
        """The targets of the training step, built from the raw batch on its
        device (reference model3d.py:273-312): the EDT prob at full
        resolution with the config's anisotropy as the spacing, subsampled
        by the grid; the star distances; -1 in the prob where a label is
        negative. The same values as the host path
        (:meth:`StarDistData3D.__getitem__`)."""
        if self._is_multiclass():
            return None
        cfg = self.config
        gz, gy, gx = (int(g) for g in cfg.grid)
        rays = self.rays
        spacing = tuple(float(a) for a in (cfg.anisotropy if cfg.anisotropy is not None
                                           else (1.0, 1.0, 1.0)))

        def fn(raw):
            x = raw["x"].float()
            y = raw["y"]                        # (B, D, H, W) int32, may be < 0
            y_pos = y.clamp_min(0)
            mask_neg = y[:, ::gz, ::gy, ::gx] < 0
            prob_raw = edt_prob_batch(y_pos, raw["labels"], spacing)[:, ::gz, ::gy, ::gx]
            dist = star_dist3d(y_pos, rays, (gz, gy, gx), _default_max_dist(y.shape[1:]),
                               n_steps=raw.get("steps"))
            dist_and_mask = torch.cat([dist, prob_raw[..., None]], dim=-1)
            prob = torch.where(mask_neg, -1.0, prob_raw)[..., None]
            return {"x": x, "prob": prob, "dist": dist_and_mask}

        return fn

    def _nms_sparse(self, dist, prob, points, nms_thresh, stats=None, **nms_kwargs):
        return non_maximum_suppression_3d_sparse(dist, prob, points, self.rays,
                                                 nms_thresh=nms_thresh, stats=stats,
                                                 **nms_kwargs)

    def _nms_dense(self, dist, prob, prob_thresh, nms_thresh, stats=None, **nms_kwargs):
        return non_maximum_suppression_3d(dist, prob, self.rays, grid=self.config.grid,
                                          prob_thresh=prob_thresh, nms_thresh=nms_thresh,
                                          stats=stats, **nms_kwargs)

    def _rescale(self, scale):
        """The survivors' factors back to the volume, (1 / s_Z, 1 / s_Y,
        1 / s_X), of a scale dict of the image's axes (reference
        model3d.py:343-346)."""
        if not (isinstance(scale, dict) and all(a in scale for a in "XYZ")):
            raise ValueError("scale must be a dictionary with entries for 'X', 'Y', and 'Z'")
        return 1 / scale["Z"], 1 / scale["Y"], 1 / scale["X"]

    def _nms_keep(self, prob, dist, points, nms_thresh):
        """Greedy-NMS keep flags (a bool tensor) of a candidate list sorted by
        descending prob, points in full-resolution voxels (reference
        model3d.py:361-370), for the threshold search. Numpy inputs go to
        ``self.device``."""
        dist = as_tensor_on(dist, self.device)
        return non_maximum_suppression_3d_inds(
            dist, as_tensor_on(points, dist.device), self.rays,
            scores=as_tensor_on(prob, dist.device), thresh=float(nms_thresh))

    def _render_survivors(self, img_shape, disti, points, probi, return_labels=True,
                          fetch=True, rescale=(1, 1, 1), overlap_label=None, prob_class=None):
        """Rasterize the NMS survivors on their device, relabel the volume
        sequentially there (keeping a negative ``overlap_label``) and build
        the result dict; reference model3d.py:372-405. ``rescale`` (the
        model's ``_rescale``) scales the centres (in f64, as the reference)
        and the rays back to the volume. With ``fetch`` the labels come back
        as int32 numpy and ``dist``, ``points``, ``prob`` as numpy; without
        it they stay tensors. The survivors' class rows ``prob_class`` add
        ``class_prob`` and ``class_id`` (:func:`.base._class_details`)."""
        rays = self.rays
        if tuple(rescale) != (1, 1, 1):
            points = points.double() * torch.tensor(rescale, dtype=torch.float64,
                                                    device=points.device)
            rays = rays.copy(scale=rescale)
        labels = None
        if return_labels:
            with span("stardist.raster.draw"):
                labels = _relabel_sequential(
                    polyhedron_to_label(disti, points, rays=rays, prob=probi, shape=img_shape,
                                        overlap_label=overlap_label, verbose=False),
                    overlap_label)
        details = dict(dist=disti, points=points, prob=probi, rays=rays,
                       rays_vertices=rays.vertices, rays_faces=rays.faces)
        if not fetch:
            return labels, {**details, **_class_details(prob_class, fetch)}
        if labels is not None:
            with span("stardist.raster.fetch"):
                labels = labels.cpu().numpy()
        with span("stardist.raster.details"):
            details.update((k, details[k].cpu().numpy()) for k in ("dist", "points", "prob"))
            return labels, {**details, **_class_details(prob_class, fetch)}

    def predict_instances_device(self, img, axes=None, normalizer=None, prob_thresh=None,
                                 nms_thresh=None, b=2, verbose=False, fetch=True):
        """Instance prediction with every stage on ``self.device`` and the
        label volume relabelled there; the counterpart of the reference's
        ``predict_instances_device`` (model3d.py:505-643), single tile.

        ``img`` is a numpy volume (``axes``, ``normalizer`` and the padding
        as in :meth:`predict_instances`) or a pre-staged tensor on
        ``self.device``: already normalized, ``(Z, Y, X)`` or ``(Z, Y, X,
        C)``, each spatial size divisible by the network stride.

        Its NMS runs the exact overlap test on a lattice of
        ``DEVICE_LATTICE_S`` = 10 points per axis, as the reference's
        device path does (model3d.py:554, ``S = 10``), where
        :meth:`predict_instances` runs the reference's host NMS's 12: it is
        ``predict_instances(..., nms_kwargs={"samples": 10})``.

        Returns ``(labels, details)`` as :meth:`predict_instances` does (a
        multiclass model's with ``class_prob`` and ``class_id``); with
        ``fetch=False`` the label volume (int32) and
        ``dist``/``points``/``prob`` (and ``class_prob``/``class_id``) stay
        tensors on ``self.device``."""
        return self.predict_instances(img, axes, normalizer, prob_thresh=prob_thresh,
                                      nms_thresh=nms_thresh, verbose=verbose,
                                      nms_kwargs={"samples": DEVICE_LATTICE_S}, b=b, fetch=fetch)

    def _axes_div_by(self, query_axes):
        """The network's stride per axis of ``query_axes``: pool ** depth *
        grid for the U-Net, the grid for the ResNet (reference
        model3d.py:645-660)."""
        if self.config.backbone == "unet":
            return super()._axes_div_by(query_axes)
        query_axes = axes_check_and_normalize(query_axes)
        grid_dict = dict(zip(self.config.axes.replace("C", ""), self.config.grid))
        return tuple(grid_dict.get(a, 1) for a in query_axes)

    @property
    def _config_class(self):
        return Config3D


def _relabel_sequential(labels, overlap_label=None):
    """Labels 1..n in the order of their values, 0 kept (``relabel_sequential``
    of a label tensor, on its device), as int32; a negative
    ``overlap_label`` stays as it is (reference model3d.py:386-394: it is
    numbered after every other label, then put back)."""
    overlap = None
    if overlap_label is not None and overlap_label < 0:
        overlap = labels == overlap_label
        if bool(overlap.any()):
            labels = torch.where(overlap, labels.amax() + 1, labels)
        else:
            overlap = None
    uniq, inv = torch.unique(labels, sorted=True, return_inverse=True)
    # id 0 stays 0: without background every id moves up by one
    out = (inv + (uniq[:1] != 0).to(inv.dtype)).to(torch.int32)
    if overlap is not None:
        out = torch.where(overlap, torch.full_like(out, int(overlap_label)), out)
    return out
