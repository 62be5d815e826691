"""2D StarDist model (counterpart of ``stardist_tpu/models/model2d.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import BaseConfig
from ..geometry import dist_to_coord, polygons_to_label
from ..nms import non_maximum_suppression_sparse
from ..utils import _normalize_grid
from .base import StarDistBase


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
    ``StarDist2D(Config2D(...), device=...)`` builds one with zero weights
    (see ``net.init_weights``)."""

    def _nms_sparse(self, dist, prob, points, nms_thresh, verbose, stats):
        return non_maximum_suppression_sparse(dist, prob, points, nms_thresh=nms_thresh,
                                              verbose=verbose, stats=stats)

    def _render_survivors(self, img_shape, disti, points, probi, return_labels=True,
                          fetch=True):
        """Rasterize the NMS survivors on their device, to uint16 when the
        label count fits (as the reference's device path ships it), and
        build the result dict. With ``fetch`` the labels come back as int32
        numpy and the dict holds numpy ``dist``, ``coord``, ``points``
        (int32) and ``prob``; without it the labels and ``dist``, ``points``,
        ``prob`` stay tensors."""
        labels = None
        if return_labels:
            small = len(probi) < 2 ** 16 - 1
            labels = polygons_to_label(disti, points, img_shape, prob=probi,
                                       out_dtype=torch.uint16 if small else torch.int32)
        if not fetch:
            return labels, dict(dist=disti, points=points, prob=probi)
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy().astype(np.int32)
        disti, points, probi = (t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                                for t in (disti, points, probi))
        coord = dist_to_coord(disti, points)
        return labels, dict(dist=disti, coord=coord, points=points.astype(np.int32), prob=probi)

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
        return self._predict_instances(img, axes, normalizer, prob_thresh, nms_thresh, None,
                                       b, True, verbose, fetch=fetch)

    @property
    def _config_class(self):
        return Config2D
