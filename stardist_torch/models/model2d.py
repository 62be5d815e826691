"""2D StarDist model (counterpart of ``stardist_tpu/models/model2d.py``):
the config, the training data and targets, training, and prediction."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.config import BaseConfig
from ..geometry import dist_to_coord, polygons_to_label
from ..nms import non_maximum_suppression, non_maximum_suppression_sparse
from ..ops.nms import nms_polygons
from ..ops.edt import edt_prob_batch
from ..ops.stardist2d import _default_max_dist, march_steps, star_dist2d
from ..sample_patches import sample_patches
from ..utils import _normalize_grid, as_tensor_on, clear_border, edt_prob
from .base import StarDistBase, StarDistDataBase


class StarDistData2D(StarDistDataBase):
    """Training batches (reference model2d.py:27-120): random
    foreground-biased patches -> augmenter -> targets. ``__getitem__``
    builds the targets on the host (scipy EDT prob, the star distances on
    ``device``: the card unless the caller passes ``device="cpu"``), as the
    validation batch and shape completion need; :meth:`raw_item` leaves
    them to the training step."""

    def __init__(self, X, Y, batch_size, n_rays, length, n_classes=None, classes=None,
                 patch_size=(256, 256), b=32, grid=(1, 1), shape_completion=False,
                 augmenter=None, foreground_prob=0, device="cuda", **kwargs):
        if n_classes is not None:
            raise NotImplementedError("multiclass training is not ported yet")
        super().__init__(X=X, Y=Y, n_rays=n_rays, grid=grid,
                         n_classes=n_classes, classes=classes,
                         batch_size=batch_size, patch_size=patch_size, length=length,
                         augmenter=augmenter, foreground_prob=foreground_prob, **kwargs)
        self.device = torch.device(device)
        self.shape_completion = bool(shape_completion)
        if self.shape_completion and b > 0:
            if not all(b % g == 0 for g in self.grid):
                raise ValueError(
                    f"'shape_completion' requires that crop size {b} "
                    f"('train_completion_crop' in config) is evenly divisible by all grid values {self.grid}")
            self.b = slice(b, -b), slice(b, -b)
        else:
            self.b = slice(None), slice(None)

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
            X, Y = list(zip(*[(x[0][self.b], y[0]) for y, x in arrays]))
        else:
            X, Y = list(zip(*[
                (np.stack([_x[0] for _x in x], axis=-1)[self.b], y[0]) for y, *x in arrays
            ]))
        X, Y = tuple(zip(*tuple(self.augmenter(_x, _y) for _x, _y in zip(X, Y))))
        return idx, X, Y

    def _star_dist(self, lbls, grid):
        lbls = np.stack(lbls).astype(np.int32)
        return star_dist2d(torch.from_numpy(lbls).to(self.device), self.n_rays, grid,
                           n_steps=march_steps(lbls)).cpu().numpy()

    def raw_item(self, i):
        """The raw batch (see :meth:`StarDistDataBase.raw_item`) and
        ``steps``, the star-distance march's bound for its labels."""
        raw = super().raw_item(i)
        raw["steps"] = march_steps(raw["y"])
        return raw

    def __getitem__(self, i):
        idx, X, Y = self._sample_batch(i)

        mask_neg_labels = tuple(y[self.b][self.ss_grid[1:3]] < 0 for y in Y)
        has_neg_labels = any(m.any() for m in mask_neg_labels)
        if has_neg_labels:
            mask_neg_labels = np.stack(mask_neg_labels)
            Y = tuple(np.maximum(y, 0) for y in Y)

        prob = np.stack([edt_prob(lbl[self.b][self.ss_grid[1:3]]) for lbl in Y])
        if self.shape_completion:
            Y_cleared = [clear_border(lbl) for lbl in Y]
            _dist = self._star_dist(Y_cleared, (1, 1))[(slice(None),) + self.b + (slice(None),)]
            dist = _dist[self.ss_grid]
            dist_mask = np.stack([edt_prob(lbl[self.b][self.ss_grid[1:3]]) for lbl in Y_cleared])
        else:
            dist = self._star_dist(Y, self.grid)
            dist_mask = prob

        X = np.stack(X)
        if X.ndim == 3:  # no channel axis
            X = np.expand_dims(X, -1)
        prob = np.expand_dims(prob, -1)
        dist_mask = np.expand_dims(dist_mask, -1)

        # the dist target carries the mask as an extra last channel
        dist_and_mask = np.empty(dist.shape[:-1] + (self.n_rays + 1,), np.float32)
        dist_and_mask[..., :-1] = dist
        dist_and_mask[..., -1:] = dist_mask

        if has_neg_labels:
            prob[mask_neg_labels] = -1  # disables the loss at these pixels
        return (X,), (prob, dist_and_mask)


class Config2D(BaseConfig):
    """Configuration for StarDist2D; the same keys, defaults and config.json
    schema as ``stardist_tpu.models.model2d.Config2D``."""

    def __init__(self, axes="YX", n_rays=32, n_channel_in=1, grid=(1, 1),
                 n_classes=None, backbone="unet", **kwargs):
        super().__init__(axes=axes, n_channel_in=n_channel_in, n_channel_out=1 + n_rays)

        self.n_rays = int(n_rays)
        self.grid = _normalize_grid(grid, 2)
        self.backbone = str(backbone).lower()
        self.n_classes = None if n_classes is None else int(n_classes)

        if self.backbone == "unet":
            self.unet_n_depth = 3
            self.unet_kernel_size = 3, 3
            self.unet_n_filter_base = 32
            self.unet_n_conv_per_depth = 2
            self.unet_pool = 2, 2
            self.unet_activation = "relu"
            self.unet_last_activation = "relu"
            self.unet_batch_norm = False
            self.unet_dropout = 0.0
            self.unet_prefix = ""
            self.net_conv_after_unet = 128
        else:
            raise ValueError("backbone '%s' not supported." % self.backbone)

        self.net_input_shape = None, None, self.n_channel_in
        self.net_mask_shape = None, None, 1

        self.train_shape_completion = False
        self.train_completion_crop = 32
        self.train_patch_size = 256, 256
        self.train_background_reg = 1e-4
        self.train_foreground_only = 0.9
        self.train_sample_cache = True

        self.train_dist_loss = "mae"
        self.train_loss_weights = (1, 0.2) if self.n_classes is None else (1, 0.2, 1)
        self.train_class_weights = (1, 1) if self.n_classes is None else (1,) * (self.n_classes + 1)
        self.train_epochs = 400
        self.train_steps_per_epoch = 100
        self.train_learning_rate = 0.0003
        self.train_batch_size = 4
        self.train_n_val_patches = None
        self.train_tensorboard = True
        self.train_reduce_lr = {"factor": 0.5, "patience": 40, "min_delta": 0}

        self.use_gpu = False

        for k in ("n_dim", "n_channel_out"):
            kwargs.pop(k, None)

        self.update_parameters(False, **kwargs)

        if not len(self.train_loss_weights) == (2 if self.n_classes is None else 3):
            raise ValueError(
                f"train_loss_weights {self.train_loss_weights} not compatible with "
                f"n_classes ({self.n_classes}): must be 3 weights if n_classes is not None, otherwise 2")
        if not len(self.train_class_weights) == (2 if self.n_classes is None else self.n_classes + 1):
            raise ValueError(
                f"train_class_weights {self.train_class_weights} not compatible with "
                f"n_classes ({self.n_classes}): must be 'n_classes + 1' weights if "
                f"n_classes is not None, otherwise 2")


class StarDist2D(StarDistBase):
    """2D StarDist model: the U-Net and the instance-prediction pipeline.

    ``StarDist2D(None, name, basedir)`` loads a saved model folder
    (``config.json``, ``thresholds.json``, ``weights_best.h5``);
    ``StarDist2D(Config2D(...), name, basedir, device=...)`` builds one with
    seeded random weights (see ``net.init_weights``) and, with a
    ``basedir``, writes its ``config.json``."""

    def train(self, X, Y, validation_data, classes="auto", augmenter=None, seed=None,
              epochs=None, steps_per_epoch=None, workers=1, resume=False):
        """Train the network on ``self.device`` (reference model2d.py:201-275).

        Negative label values disable all losses at those pixels.
        ``resume=True`` continues an interrupted training from the last
        epoch's ``train_state.pt`` as an uninterrupted run would have gone
        on (bitwise on the CPU). ``workers`` is taken for the reference's
        signature: one producer thread makes the batches. Returns the
        :class:`History`."""
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
        b = self.config.train_completion_crop if self.config.train_shape_completion else 0
        div_by = self._axes_div_by(axes)
        for p, d, a in zip(patch_size, div_by, axes):
            if (p - 2 * b) % d != 0:
                raise ValueError(
                    f"'train_patch_size' - 2*'train_completion_crop' must be divisible by {d} along axis '{a}'"
                    if self.config.train_shape_completion else
                    f"'train_patch_size' must be divisible by {d} along axis '{a}'")

        if not self._model_prepared:
            self.prepare_for_training()

        data_kwargs = dict(
            n_rays=self.config.n_rays,
            patch_size=self.config.train_patch_size,
            grid=self.config.grid,
            shape_completion=self.config.train_shape_completion,
            b=self.config.train_completion_crop,
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
        _data_val = StarDistData2D(validation_data[0], validation_data[1], classes=classes_val,
                                   batch_size=n_take, length=1, **data_kwargs)
        data_val = _data_val[0]

        self.data_train = StarDistData2D(X, Y, classes=classes,
                                         batch_size=self.config.train_batch_size,
                                         augmenter=augmenter,
                                         length=epochs * steps_per_epoch, **data_kwargs)

        val_batch = _as_batch_dict(data_val)
        use_raw = self._targets_fn is not None and self.data_train.supports_raw
        train_data = _BatchDictAdapter(self.data_train, raw=use_raw)
        return self._fit(train_data, val_batch, epochs, steps_per_epoch, resume=resume)

    def _device_targets_fn(self):
        """The targets of the training step, built from the raw batch on its
        device (reference model2d.py:277-312): the EDT prob (exact
        separable min-plus, one-vs-rest over each patch's labels) and the
        star distances, the same values as the host path
        (:meth:`StarDistData2D.__getitem__`); None for shape completion."""
        if self._is_multiclass() or self.config.train_shape_completion:
            return None
        gy, gx = (int(g) for g in self.config.grid)
        n_rays = int(self.config.n_rays)

        def fn(raw):
            x = raw["x"].float()
            y = raw["y"]                        # (B, H, W) int32, may be < 0
            y_pos = y.clamp_min(0)
            mask_neg = y[:, ::gy, ::gx] < 0
            prob_raw = edt_prob_batch(y_pos[:, ::gy, ::gx], raw["labels"])
            dist = star_dist2d(y_pos, n_rays, (gy, gx), _default_max_dist(y.shape[1:]),
                               n_steps=raw.get("steps"))
            dist_and_mask = torch.cat([dist, prob_raw[..., None]], dim=-1)
            prob = torch.where(mask_neg, -1.0, prob_raw)[..., None]
            return {"x": x, "prob": prob, "dist": dist_and_mask}

        return fn

    def _nms_sparse(self, dist, prob, points, nms_thresh, stats=None, **nms_kwargs):
        return non_maximum_suppression_sparse(dist, prob, points, nms_thresh=nms_thresh,
                                              stats=stats, **nms_kwargs)

    def _nms_dense(self, dist, prob, prob_thresh, nms_thresh, stats=None, **nms_kwargs):
        return non_maximum_suppression(dist, prob, grid=self.config.grid,
                                       prob_thresh=prob_thresh, nms_thresh=nms_thresh,
                                       stats=stats, **nms_kwargs)

    def _rescale(self, scale):
        """The survivors' factors back to the image, (1 / s_Y, 1 / s_X), of a
        scale dict of the image's axes (reference model2d.py:341-347)."""
        if not (isinstance(scale, dict) and "X" in scale and "Y" in scale):
            raise ValueError("scale must be a dictionary with entries for 'X' and 'Y'")
        return 1 / scale["Y"], 1 / scale["X"]

    def _nms_keep(self, prob, dist, points, nms_thresh):
        """Greedy-NMS keep flags (a bool tensor) of a candidate list sorted by
        descending prob, points in full-resolution pixels (reference
        model2d.py:356-362): the threshold search's NMS, one per image and
        ``nms_thresh``, whose first n flags are those of NMS on the first n
        candidates. Numpy inputs go to ``self.device``."""
        dist = as_tensor_on(dist, self.device)
        return nms_polygons(dist, as_tensor_on(points, dist.device), thresh=float(nms_thresh))

    def _render_survivors(self, img_shape, disti, points, probi, return_labels=True,
                          fetch=True, rescale=(1, 1)):
        """Rasterize the NMS survivors on their device, to uint16 when the
        label count fits (as the reference's device path ships it), and
        build the result dict. ``rescale`` (the model's ``_rescale``)
        scales the centres (in f64, as the reference) and the polygons back
        to the image. With ``fetch`` the labels come back as int32 numpy and
        the dict holds numpy ``dist``, ``coord``, ``points`` (int32; f64
        when scaled) and ``prob``; without it the labels and ``dist``,
        ``points``, ``prob`` stay tensors."""
        scaled = tuple(rescale) != (1, 1)
        if scaled:
            points = points.double() * torch.tensor(rescale, dtype=torch.float64,
                                                    device=points.device)
        labels = None
        if return_labels:
            small = len(probi) < 2 ** 16 - 1
            labels = polygons_to_label(disti, points, img_shape, prob=probi,
                                       scale_dist=rescale,
                                       out_dtype=torch.uint16 if small else torch.int32)
        if not fetch:
            return labels, dict(dist=disti, points=points, prob=probi)
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy().astype(np.int32)
        disti, points, probi = (t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                                for t in (disti, points, probi))
        coord = dist_to_coord(disti, points, scale_dist=rescale)
        return labels, dict(dist=disti, coord=coord,
                            points=points if scaled else points.astype(np.int32), prob=probi)

    def predict_instances_device(self, img, axes=None, normalizer=None, prob_thresh=None,
                                 nms_thresh=None, b=2, verbose=False, fetch=True):
        """Instance prediction with every stage on ``self.device`` and only
        scalars read back by the host before the result (counts, the
        largest dist); the counterpart of the reference's
        ``predict_instances_device`` (model2d.py:485-654), single tile.

        ``img`` is a numpy image (``axes``, ``normalizer`` and the padding
        as in :meth:`predict_instances`) or a pre-staged tensor on
        ``self.device``: already normalized, ``(Y, X)`` or ``(Y, X, C)``,
        each spatial size divisible by the network stride.

        Returns ``(labels, details)`` as :meth:`predict_instances` does;
        with ``fetch=False`` the label image (uint16 when the label count
        fits, else int32) and ``dist``/``points``/``prob`` stay tensors on
        ``self.device``."""
        if self.config.n_classes is not None:
            raise NotImplementedError("multiclass prediction is not ported yet")
        return self.predict_instances(img, axes, normalizer, prob_thresh=prob_thresh,
                                      nms_thresh=nms_thresh, verbose=verbose, b=b, fetch=fetch)

    @property
    def _config_class(self):
        return Config2D


def _as_batch_dict(batch_tuple):
    (x,), targets = batch_tuple
    return {"x": x, "prob": targets[0], "dist": targets[1]}


class _BatchDictAdapter:
    """Training batches as dicts: the raw batch of the fused step, or the
    host path's targets."""

    def __init__(self, seq, raw=False):
        self.seq = seq
        self.raw = raw

    def __getitem__(self, i):
        if self.raw:
            return self.seq.raw_item(i)
        return _as_batch_dict(self.seq[i])
