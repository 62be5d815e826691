"""3D StarDist model (counterpart of ``stardist_tpu/models/model3d.py``)."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.config import BaseConfig
from ..geometry import polyhedron_to_label
from ..matching import relabel_sequential
from ..nms import non_maximum_suppression_3d_sparse
from ..rays3d import Rays_GoldenSpiral, rays_from_json
from ..utils import _normalize_grid
from .base import StarDistBase


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
    """3D StarDist model: the U-Net and the instance-prediction pipeline.

    ``StarDist3D(None, name, basedir)`` loads a saved model folder
    (``config.json``, ``thresholds.json``, ``weights_best.h5``);
    ``StarDist3D(Config3D(...), device=...)`` builds one with seeded random
    weights (see ``net.init_weights``). The resnet backbone and training
    are not ported."""

    @property
    def rays(self):
        return rays_from_json(self.config.rays_json)

    def _nms_sparse(self, dist, prob, points, nms_thresh, verbose, stats):
        return non_maximum_suppression_3d_sparse(dist, prob, points, self.rays,
                                                 nms_thresh=nms_thresh, verbose=verbose,
                                                 stats=stats)

    def _render_survivors(self, img_shape, disti, points, probi, return_labels=True):
        """Rasterize the NMS survivors (on their device), relabel the volume
        sequentially and build the result dict (numpy); reference
        model3d.py:372-405."""
        rays = self.rays
        labels = None
        if return_labels:
            labels = polyhedron_to_label(disti, points, rays=rays, prob=probi,
                                         shape=img_shape, verbose=False)
            if isinstance(labels, torch.Tensor):
                labels = labels.cpu().numpy()
            labels, _, _ = relabel_sequential(labels)
        disti, points, probi = (t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                                for t in (disti, points, probi))
        return labels, dict(dist=disti, points=points, prob=probi, rays=rays,
                            rays_vertices=rays.vertices, rays_faces=rays.faces)

    @property
    def _config_class(self):
        return Config3D
