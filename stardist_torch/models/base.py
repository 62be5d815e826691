"""Model base: the model folder, training and the prediction pipeline
(counterpart of ``stardist_tpu/models/base.py``).

Training (:meth:`StarDistBase.prepare_for_training`, :meth:`StarDistBase.
_fit`): Adam with optax's defaults, ReduceLROnPlateau on the validation
loss, the three checkpoints the config names (weights files the JAX package
reads too), ``logs/history.jsonl`` and TensorBoard where it imports, and
``train_state.pt`` for a bitwise resume. A producer thread samples and
augments the batches on the host, four ahead of the step; the step uploads
them (pinned, non-blocking on CUDA), builds the targets there when the
model has a targets function (``_device_targets_fn``), and runs the loss,
the backward pass and the update on ``self.device``; the metrics stay there
until the epoch ends.

``predict_instances`` = normalize -> pad -> U-Net forward -> candidate
extraction (threshold, border mask, gather of the candidates' dist columns)
-> greedy NMS -> label rasterization. Everything after the image upload
runs on ``self.device``; only the survivors' arrays and the label image are
copied back. With ``n_tiles`` the padded image is cut into overlapping
tiles (``core/tiling.py``); each tile's forward and extraction run in turn
and the candidate lists are joined in tile order. ``predict`` is the dense
prediction (prob and dist maps as numpy); ``predict_instances(sparse=False)``
thresholds those maps on ``self.device`` instead of extracting candidates.
``optimize_thresholds`` searches the thresholds on validation images
(``utils.optimize_threshold``).
"""
from __future__ import annotations

import datetime
import json
import math
import numbers
import queue
import threading
import time
import warnings
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

from ..core.axes import axes_check_and_normalize, axes_dict, move_image_axes
from ..core.normalize import NoNormalizer, Normalizer
from ..core.tiling import tile_iterator
from ..sample_patches import get_valid_inds
from ..utils import _is_power_of_2, grid_divisible_patch_size, optimize_threshold
from . import losses as L
from .unet import StarDistNet
from .weights import load_flax_checkpoint, params_from_flax, save_flax_checkpoint

INIT_SEED = 42           # a fresh model's weights, as the reference's
Thresholds = namedtuple("Thresholds", ("prob", "nms"))
METRICS = ("loss", "prob_loss", "dist_loss", "prob_kld", "dist_relevant_mae",
           "dist_relevant_mse", "dist_dist_iou_metric")


class RollingSequence:
    """Epoch-reshuffled batch index sequence (csbdeep's RollingSequence)."""

    def __init__(self, data_size, batch_size, length, shuffle=True, seed=0, keras_kwargs=None):
        self.data_size = int(data_size)
        self.batch_size = int(batch_size)
        self.length = int(length)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self._perm_cache = {}

    def __len__(self):
        return self.length

    def _perm(self, epoch):
        if not self.shuffle:
            return np.arange(self.data_size)
        if epoch not in self._perm_cache:
            self._perm_cache[epoch] = np.random.RandomState(self.seed + epoch).permutation(self.data_size)
            if len(self._perm_cache) > 64:
                self._perm_cache.pop(next(iter(self._perm_cache)))
        return self._perm_cache[epoch]

    def batch(self, i):
        pos = np.arange(i * self.batch_size, (i + 1) * self.batch_size)
        return np.array([self._perm(p // self.data_size)[p % self.data_size] for p in pos])

    def __getitem__(self, i):
        raise NotImplementedError

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class StarDistDataBase(RollingSequence):
    """Training data: foreground-biased patch centers with per-image caches,
    grid slicing, the augmenter hook (reference base.py:92-209)."""

    @property
    def supports_raw(self):
        """True when the targets can be built in the training step from the
        raw batch (:meth:`raw_item`) instead of on the host."""
        return self.n_classes is None and not getattr(self, "shape_completion", False)

    def raw_item(self, i):
        """The raw batch of the fused training step: the patches ``x``, the
        label patches ``y`` (int32) and each patch's positive labels
        ``labels`` (B, L), 0-padded to the largest count of the batch."""
        _, X, Y = self._sample_batch(i)
        X = np.stack(X)
        if X.ndim == len(self.patch_size) + 1:  # no channel axis
            X = np.expand_dims(X, -1)
        Yi = np.stack([y.astype(np.int32, copy=False) for y in Y])
        labs = [np.unique(y[y > 0]) for y in Yi]
        labels = np.zeros((len(labs), max([1] + [len(l) for l in labs])), np.int32)
        for j, l in enumerate(labs):
            labels[j, :len(l)] = l
        return {"x": X.astype(np.float32, copy=False), "y": Yi, "labels": labels}

    def __init__(self, X, Y, n_rays, grid, batch_size, patch_size, length,
                 n_classes=None, classes=None, use_gpu=False, sample_ind_cache=True,
                 maxfilter_patch_size=None, augmenter=None, foreground_prob=0,
                 keras_kwargs=None):
        super().__init__(data_size=len(X), batch_size=batch_size, length=length, shuffle=True)

        if isinstance(X, (np.ndarray, tuple, list)):
            X = [x.astype(np.float32, copy=False) for x in X]

        if not (len(X) == len(Y) and len(X) > 0):
            raise ValueError("X and Y can't be empty and must have same length")

        if classes is None:
            classes = (None,) * len(X)
        elif n_classes is None:
            warnings.warn("Ignoring classes since n_classes is None")
        if len(classes) != len(X):
            raise ValueError("X and classes must have same length")

        self.n_classes, self.classes = n_classes, classes
        patch_size = grid_divisible_patch_size(patch_size, grid)

        nD = len(patch_size)
        assert nD in (2, 3)
        x_ndim = X[0].ndim
        assert x_ndim in (nD, nD + 1)

        if isinstance(X, (np.ndarray, tuple, list)) and isinstance(Y, (np.ndarray, tuple, list)):
            if not all(y.ndim == nD and x.ndim == x_ndim and x.shape[:nD] == y.shape for x, y in zip(X, Y)):
                raise ValueError("images and masks should have corresponding shapes/dimensions")
            if not all(x.shape[:nD] >= tuple(patch_size) for x in X):
                raise ValueError(f"Some images are too small for given patch_size {patch_size}")

        self.n_channel = None if x_ndim == nD else X[0].shape[-1]
        if self.n_channel is not None and isinstance(X, (np.ndarray, tuple, list)):
            assert all(x.shape[-1] == self.n_channel for x in X)

        assert 0 <= foreground_prob <= 1

        self.X, self.Y = X, Y
        self.n_rays = n_rays
        self.patch_size = patch_size
        self.ss_grid = (slice(None),) + tuple(slice(0, None, g) for g in grid)
        self.grid = tuple(grid)
        self.use_gpu = bool(use_gpu)
        if augmenter is None:
            augmenter = lambda *args: args
        if not callable(augmenter):
            raise ValueError("augmenter must be None or callable")
        self.augmenter = augmenter
        self.foreground_prob = foreground_prob

        from scipy.ndimage import maximum_filter
        self.max_filter = lambda y, patch_size: maximum_filter(y, patch_size, mode="constant")
        self.maxfilter_patch_size = maxfilter_patch_size if maxfilter_patch_size is not None else self.patch_size

        self.sample_ind_cache = sample_ind_cache
        self._ind_cache_fg = {}
        self._ind_cache_all = {}
        self.lock = threading.Lock()

    def get_valid_inds(self, k, foreground_prob=None):
        if foreground_prob is None:
            foreground_prob = self.foreground_prob
        foreground_only = np.random.uniform() < foreground_prob
        _ind_cache = self._ind_cache_fg if foreground_only else self._ind_cache_all
        if k in _ind_cache:
            inds = _ind_cache[k]
        else:
            patch_filter = (
                (lambda y, p: self.max_filter(y, self.maxfilter_patch_size) > 0)
                if foreground_only else None
            )
            inds = get_valid_inds(self.Y[k], self.patch_size, patch_filter=patch_filter)
            if self.sample_ind_cache:
                with self.lock:
                    _ind_cache[k] = inds
        if foreground_only and len(inds[0]) == 0:
            return self.get_valid_inds(k, foreground_prob=0)
        return inds

    def channels_as_tuple(self, x):
        if self.n_channel is None:
            return (x,)
        return tuple(x[..., i] for i in range(self.n_channel))


class History:
    """Per-epoch logs (``history``, as Keras's) and the training metrics of
    each step this call ran (``steps``)."""

    def __init__(self):
        self.history = {}
        self.steps = {}

    def append(self, logs):
        for k, v in logs.items():
            self.history.setdefault(k, []).append(float(v))


def _np_rng_state(state):
    """np.random.get_state() as tensors and numbers (a weights-only
    torch.save holds it)."""
    return {"keys": torch.from_numpy(np.asarray(state[1], np.int64)), "pos": int(state[2]),
            "has_gauss": int(state[3]), "cached_gaussian": float(state[4])}


def _np_rng_state_from(d):
    return ("MT19937", d["keys"].numpy().astype(np.uint32), d["pos"], d["has_gauss"],
            d["cached_gaussian"])


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
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
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
        elif not config.is_valid():
            raise ValueError("Invalid configuration")
        if name is None:
            name = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S.%f")
        self.config = config
        self.name = name
        self._model_prepared = False
        # a callable the training loop calls with the name of each stage of a
        # step as it is issued (start, wait, upload, targets, forward+backward,
        # optimizer), to time them; None: nothing is called
        self.step_marks = None
        self.net = StarDistNet(config)
        # the reference's weights come from seed 42; these from a seeded CPU
        # generator, so that the CPU and the card start from the same ones
        self.net.init_weights(torch.Generator().manual_seed(INIT_SEED))
        if inference_dtype is None:
            inference_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        self.set_inference_precision(inference_dtype)

        if self.basedir is not None:
            self.logdir.mkdir(parents=True, exist_ok=True)
            if loading:
                weights = self._weights_file()
                if weights is None:
                    warnings.warn(f"no network weights found in {self.logdir}")
                else:
                    self.load_weights(weights.name)
            else:
                with open(self.logdir / "config.json", "w") as f:
                    json.dump(self.config.to_dict(), f)
        threshs = {}
        if self.basedir is not None:
            try:
                with open(self.logdir / "thresholds.json") as f:
                    threshs = json.load(f)
            except FileNotFoundError:
                pass
        prob = threshs.get("prob")
        nms = threshs.get("nms")
        self.thresholds = Thresholds(
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

    def load_weights(self, name="weights_best.h5"):
        """Load a flax msgpack checkpoint (the reference's ``.h5`` files):
        ``name`` in the model folder, or an absolute path."""
        path = Path(name) if Path(name).is_absolute() else self.logdir / name
        if path.read_bytes()[:4] == b"\x89HDF":
            raise NotImplementedError("Keras HDF5 import is not ported yet")
        sd = params_from_flax(self.net, load_flax_checkpoint(path))
        self.net.load_state_dict(sd)
        self.net.to(self.device)

    def save_weights(self, name="weights_best.h5"):
        """Write the weights into the model folder as the reference's flax
        checkpoint, which both packages load."""
        save_flax_checkpoint(self.logdir / name, self.net)

    # -- training -------------------------------------------------------------

    def _is_multiclass(self):
        return self.config.n_classes is not None

    def _parse_classes_arg(self, classes, length):
        if isinstance(classes, str):
            if classes != "auto":
                raise ValueError(f"classes = '{classes}': only 'auto' supported as string")
            if self.config.n_classes is None:
                classes = None
            elif self.config.n_classes == 1:
                classes = (1,) * length
            else:
                raise ValueError("using classes = 'auto' for n_classes > 1 not supported")
        elif isinstance(classes, (tuple, list, np.ndarray)):
            if len(classes) != length:
                raise ValueError(f"len(classes) should be {length}!")
        else:
            raise ValueError("classes should either be 'auto' or a list of scalars/label dicts")
        return classes

    def _device_targets_fn(self):
        """The function that builds the training targets from a raw batch on
        ``self.device``, or None (the model's subclass says)."""
        return None

    def prepare_for_training(self, optimizer=None):
        """Set up the optimizer (Adam with optax's defaults: betas 0.9 /
        0.999, eps 1e-8) and the targets function of the training step."""
        if optimizer is None:
            optimizer = torch.optim.Adam(self.net.parameters(), lr=self.config.train_learning_rate,
                                         betas=(0.9, 0.999), eps=1e-8)
        self.optimizer = optimizer
        self._targets_fn = self._device_targets_fn()
        self._model_prepared = True

    def _loss_and_metrics(self, batch, generator=None):
        """(loss, metrics dict) of a target batch ``{"x", "prob", "dist"}``
        on the device; the metrics are computed without autograd."""
        cfg = self.config
        w = tuple(cfg.train_loss_weights)
        n_rays = cfg.n_rays
        prob_pred, dist_pred = self.net.train_forward(batch["x"], generator)
        prob_true, dist_true = batch["prob"][..., 0], batch["dist"][..., :n_rays]
        dist_mask = batch["dist"][..., n_rays:]
        lp = L.prob_loss(prob_true, prob_pred[..., 0])
        ld = L.dist_loss(dist_true, dist_mask, dist_pred, kind=cfg.train_dist_loss,
                         reg_weight=float(cfg.train_background_reg))
        loss = w[0] * lp + w[1] * ld
        with torch.no_grad():
            p, d = prob_pred.detach()[..., 0], dist_pred.detach()
            metrics = {"loss": loss.detach(), "prob_loss": lp.detach(), "dist_loss": ld.detach(),
                       "prob_kld": L.kld_metric(prob_true, p),
                       "dist_relevant_mae": L.relevant_mae(dist_true, dist_mask, d),
                       "dist_relevant_mse": L.relevant_mse(dist_true, dist_mask, d),
                       "dist_dist_iou_metric": L.dist_iou_metric(dist_true, dist_mask, d)}
        return loss, metrics

    def _put_batch(self, batch):
        """A batch's arrays as tensors on the device (non-blocking from
        pinned memory); other entries as they are."""
        return {k: (torch.as_tensor(v).to(self.device, non_blocking=True)
                    if isinstance(v, (np.ndarray, torch.Tensor)) else v)
                for k, v in batch.items()}

    def _train_step(self, batch, generator=None, marks=None):
        """One update from a device batch (raw: targets built first) ->
        the metrics as one tensor on the device, in the order of METRICS.
        ``marks(stage)``, where given, is called as each stage is issued."""
        if "y" in batch:
            batch = self._targets_fn(batch)
        if marks is not None:
            marks("targets")
        loss, metrics = self._loss_and_metrics(batch, generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if marks is not None:
            marks("forward+backward")
        self.optimizer.step()
        if marks is not None:
            marks("optimizer")
        return torch.stack([metrics[k] for k in METRICS])

    def _set_lr(self, lr):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _save_train_state(self, epoch, generator, lr, best_ckpt, best_plateau, plateau_wait,
                          history, np_state):
        """Everything a resumed training needs to continue bitwise:
        ``train_state.pt`` (the JAX package's is ``train_state.msgpack``)."""
        state = {"epoch": int(epoch), "lr": float(lr), "best_ckpt": float(best_ckpt),
                 "best_plateau": float(best_plateau), "plateau_wait": int(plateau_wait),
                 "history": {k: list(v) for k, v in history.items()},
                 "params": {k: v.detach().cpu() for k, v in self.net.state_dict().items()},
                 "opt_state": self.optimizer.state_dict(),
                 "generator": generator.get_state()}
        if np_state is not None:
            state["np_rng"] = _np_rng_state(np_state)
        torch.save(state, self.logdir / "train_state.pt")

    def _load_train_state(self):
        path = self.logdir / "train_state.pt" if self.basedir is not None else None
        if path is None or not path.exists():
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def _fit(self, data_train, val_batch, epochs, steps_per_epoch, resume=False):
        """The training loop (reference base.py:751-870): a step per batch
        from the producer thread, validation each epoch, ReduceLROnPlateau,
        the checkpoints. ``resume=True`` restores ``train_state.pt`` (the
        weights, Adam's state, the dropout generator, the learning-rate and
        plateau trackers, the history, and numpy's global RNG as it was at
        the data stream's epoch boundary) and continues as an uninterrupted
        run would."""
        cfg = self.config
        generator = torch.Generator(device=self.device).manual_seed(0)   # dropout
        history = History()
        best_ckpt = best_plateau = np.inf
        rlrop = cfg.train_reduce_lr
        plateau_wait, lr = 0, float(cfg.train_learning_rate)
        factor = patience = min_delta = None
        if rlrop is not None:
            factor = float(rlrop.get("factor", 0.5))
            patience = int(rlrop.get("patience", 10))
            min_delta = float(rlrop.get("min_delta", rlrop.get("epsilon", 0)))

        start_epoch = 0
        if resume:
            state = self._load_train_state()
            if state is None:
                warnings.warn("resume=True but no train_state.pt found; starting from scratch")
            else:
                start_epoch = state["epoch"]
                history.history = {k: list(v) for k, v in state["history"].items()}
                if start_epoch >= epochs:
                    print(f"resume: training already completed ({start_epoch}/{epochs} epochs)")
                    return history
                lr, best_ckpt, best_plateau = state["lr"], state["best_ckpt"], state["best_plateau"]
                plateau_wait = state["plateau_wait"]
                if "np_rng" in state:
                    np.random.set_state(_np_rng_state_from(state["np_rng"]))
                self.net.load_state_dict(state["params"])
                self.optimizer.load_state_dict(state["opt_state"])
                generator.set_state(state["generator"])
                self._set_lr(lr)

        if val_batch is not None:
            val_batch = self._put_batch(val_batch)
        jsonl_path = tb_writer = None
        if self.basedir is not None:
            log_dir = self.logdir / "logs"
            log_dir.mkdir(parents=True, exist_ok=True)
            jsonl_path = log_dir / "history.jsonl"
            if getattr(cfg, "train_tensorboard", False):
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    tb_writer = SummaryWriter(log_dir=str(log_dir))
                except Exception:
                    tb_writer = None

        # the producer runs ahead of the steps, so numpy's RNG state at each
        # epoch's first item is taken in the data stream, for the resume
        prefetch_q = queue.Queue(maxsize=4)
        stop = threading.Event()
        epoch_np_rng = {}
        epoch_np_rng_lock = threading.Lock()
        pin = self.device.type == "cuda"

        def put(item):
            while not stop.is_set():
                try:
                    prefetch_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            for s in range(start_epoch * steps_per_epoch, epochs * steps_per_epoch):
                if stop.is_set():
                    return
                if s % steps_per_epoch == 0:
                    with epoch_np_rng_lock:
                        epoch_np_rng[s // steps_per_epoch] = np.random.get_state()
                try:
                    item = data_train[s]
                    if pin:
                        item = {k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray)
                                else v for k, v in item.items()}
                except Exception as e:          # raised again by the consumer
                    put(e)
                    return
                put(item)
            with epoch_np_rng_lock:
                epoch_np_rng[epochs] = np.random.get_state()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        trackers = dict(best_ckpt=best_ckpt, best_plateau=best_plateau,
                        plateau_wait=plateau_wait, lr=lr)
        try:
            self._fit_epochs(epochs, steps_per_epoch, prefetch_q, generator, history, jsonl_path,
                             tb_writer, trackers, factor, patience, min_delta, rlrop, val_batch,
                             start_epoch, epoch_np_rng, epoch_np_rng_lock)
        finally:
            if tb_writer is not None:
                tb_writer.close()
            stop.set()
            thread.join()
        self._training_finished()
        return history

    def _tb_log_images(self, tb_writer, val_batch, step, n_images=3):
        """TensorBoard panels of the validation batch: input, true and
        predicted object probability, three evenly spaced rays of the
        predicted distances (the inference route's forward)."""
        x = val_batch["x"][:n_images]
        preds = [self.net(xi) for xi in x]
        prob_p = torch.stack([p for p, _ in preds])[..., None]
        dist_p = torch.stack([d.movedim(0, -1) for _, d in preds])
        n_rays = self.config.n_rays
        k = n_rays // min(3, n_rays)
        groups = {"input": x[..., :1], "prob/true": val_batch["prob"][:n_images, ..., :1],
                  "prob/pred": prob_p, "dist/pred": dist_p[..., 0:k * min(3, n_rays):k]}
        for name, g in groups.items():
            g = g.float().cpu().numpy()
            for i in range(g.shape[0]):
                for c in range(g.shape[-1]):
                    img = g[i, ..., c]
                    lo, hi = float(img.min()), float(img.max())
                    img = (img - lo) / (hi - lo) if hi > lo else img * 0
                    tag = name if g.shape[-1] == 1 else f"{name}/ch{c}"
                    tb_writer.add_image(f"{tag}/{i}", img[None], step)

    def _fit_epochs(self, epochs, steps_per_epoch, prefetch_q, generator, history, jsonl_path,
                    tb_writer, trackers, factor, patience, min_delta, rlrop, val_batch,
                    start_epoch, epoch_np_rng, epoch_np_rng_lock):
        cfg = self.config
        best_ckpt, best_plateau = trackers["best_ckpt"], trackers["best_plateau"]
        plateau_wait, lr = trackers["plateau_wait"], trackers["lr"]
        marks = self.step_marks
        for epoch in range(start_epoch, epochs):
            steps = []
            for _ in range(steps_per_epoch):
                if marks is not None:
                    marks("start")
                batch = prefetch_q.get()
                if isinstance(batch, Exception):
                    raise batch
                if marks is not None:
                    marks("wait")
                batch = self._put_batch(batch)
                if marks is not None:
                    marks("upload")
                steps.append(self._train_step(batch, generator, marks))
            per_step = torch.stack(steps).cpu().numpy()           # the epoch's one readback
            for j, k in enumerate(METRICS):
                history.steps.setdefault(k, []).extend(per_step[:, j].tolist())
            logs = {k: float(np.mean(per_step[:, j])) for j, k in enumerate(METRICS)}
            logs["lr"] = lr
            if val_batch is not None:
                with torch.no_grad():
                    _, val_metrics = self._loss_and_metrics(val_batch, generator)
                logs.update({f"val_{k}": float(v) for k, v in val_metrics.items()})
            history.append(logs)
            monitor = logs.get("val_loss", logs["loss"])
            print(f"epoch {epoch + 1}/{epochs} - " +
                  " - ".join(f"{k}: {v:.4f}" for k, v in logs.items()), flush=True)
            if jsonl_path is not None:
                with open(jsonl_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch + 1, **logs}) + "\n")
            if tb_writer is not None:
                for k, v in logs.items():
                    tb_writer.add_scalar(k, v, epoch + 1)
                if val_batch is not None:
                    self._tb_log_images(tb_writer, val_batch, epoch + 1)

            if self.basedir is not None:
                self.save_weights(cfg.train_checkpoint_epoch)
                self.save_weights(cfg.train_checkpoint_last)
                if monitor < best_ckpt:
                    self.save_weights(cfg.train_checkpoint)
            best_ckpt = min(best_ckpt, monitor)
            if monitor < best_plateau - (min_delta or 0):
                best_plateau = monitor
                plateau_wait = 0
            else:
                plateau_wait += 1
                if rlrop is not None and plateau_wait >= patience:
                    lr *= factor
                    self._set_lr(lr)
                    plateau_wait = 0
                    print(f"ReduceLROnPlateau: reducing learning rate to {lr:g}", flush=True)

            if self.basedir is not None:
                # numpy's RNG state at the next epoch's boundary of the data
                # stream (the producer may not have got there yet)
                np_state = None
                for _ in range(2000):
                    with epoch_np_rng_lock:
                        np_state = epoch_np_rng.get(epoch + 1)
                    if np_state is not None:
                        break
                    time.sleep(0.005)
                self._save_train_state(epoch + 1, generator, lr, best_ckpt, best_plateau,
                                       plateau_wait, history.history, np_state)

    def _training_finished(self):
        if self.basedir is not None:
            self.save_weights(self.config.train_checkpoint_last)

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
    def _extract(prob, dist, prob_thresh, b_key, max_candidates=None):
        """Candidates above ``prob_thresh`` and inside the border: (prob (K,),
        dist (K, R) clamped at 1e-3, points (K, n_dim) in output-grid units).

        The list comes in the reference's ``lax.top_k`` order: descending
        prob, ties in ascending flat index. The NMS then sorts it with
        :func:`..nms.descending_order`, which puts ties in descending flat
        index, as the reference's ``np.argsort(prob, kind="stable")[::-1]``
        does on the same list. With ``max_candidates`` the list keeps its
        first ``max_candidates`` (the top-K by prob), with a warning when
        there were more."""
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
        if max_candidates is not None:
            cap = min(prob.numel(), int(max_candidates))
            if len(order) > cap:
                warnings.warn(f"number of candidates ({len(order)}) exceeds max_candidates "
                              f"({cap}); keeping the top-K by probability")
                order = order[:cap]
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
        ``max_candidates`` keeps the top-K of each tile (of the padded
        image when it is one tile), with a warning when there were more, as
        the reference's default route does; ``device_dist`` is not
        ported."""
        if device_dist:
            raise NotImplementedError("predict_sparse(device_dist=True) is not ported: "
                                      "predict_instances keeps the candidates on the device")
        return tuple(t.cpu().numpy() for t in self._predict_sparse(
            img, prob_thresh, axes, normalizer, n_tiles, b, max_candidates=max_candidates,
            fold_padding=False))

    def _predict_sparse(self, img, prob_thresh=None, axes=None, normalizer=None,
                        n_tiles=None, b=2, timings=None, max_candidates=None,
                        fold_padding=True):
        """Sparse prediction: (prob (K,), dist (K, R), points (K, n_dim))
        tensors on ``self.device``; points in full-resolution pixels.

        ``img`` is a numpy image, or a pre-staged tensor on ``self.device``
        (see :meth:`_prestaged`). With ``n_tiles`` (one count per axis of
        ``img``) each tile's candidates are those of its core, minus the
        border ``b`` at the image's edges; the lists are joined in tile
        order, each in its tile's ``top_k`` order (reference
        base.py:1395-1432), and candidates in the padding are dropped. In
        one tile, ``fold_padding`` leaves the padding out of the mask (the
        reference's ``device_dist`` route, that of its ``predict_instances``)
        instead of dropping its candidates after the extraction: the two
        differ only in what ``max_candidates`` keeps."""
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
                vals, d, points = self._extract(prob, dist, float(prob_thresh), b_key,
                                                max_candidates)
                offset = torch.tensor([s_d.start - s_s.start for s_s, s_d in zip(s_src, s_dst)],
                                      device=self.device)
                parts.append((vals, d, (points + offset) * grid))
                _sync(self.device)
                t_fwd += t1 - t0
                t_ext += time.perf_counter() - t1
            t1 = time.perf_counter()
            vals, d, points = (torch.cat(t) for t in zip(*parts))
            inside = torch.all(points < self._inside_bounds(axes_net, resizer), dim=1)
            vals, d, points = vals[inside], d[inside], points[inside]
            _sync(self.device)
            t_ext += time.perf_counter() - t1
        else:
            if fold_padding or resizer is None:
                b_key = self._border_key(b, x, axes_net, resizer)
            else:
                b_key = (b if b is not None and not np.isscalar(b)
                         else ((-1, -1) if b is None else (b, b),) * len(self.config.grid))
            t0 = time.perf_counter()
            prob, dist = self.net(self._upload(x))
            _sync(self.device)
            t1 = time.perf_counter()
            vals, d, points = self._extract(prob, dist, float(prob_thresh), b_key,
                                            max_candidates)
            points = points * grid[None]
            if not fold_padding and resizer is not None:
                inside = torch.all(points < self._inside_bounds(axes_net, resizer), dim=1)
                vals, d, points = vals[inside], d[inside], points[inside]
            _sync(self.device)
            t_fwd, t_ext = t1 - t0, time.perf_counter() - t1
        if timings is not None:
            timings.update(forward=t_fwd, extract=t_ext)
        return vals, d, points

    def _inside_bounds(self, axes_net, resizer):
        """Per spatial axis, the end of the image within the padded input
        (full-resolution pixels): the reference's ``filter_points``."""
        return torch.tensor([resizer.padded_shape[a] - resizer.pad[a][1]
                             for a in axes_net if a != "C"], device=self.device)

    def predict(self, img, axes=None, normalizer=None, n_tiles=None, show_tile_progress=True):
        """Dense prediction (reference base.py:1325-1373): prob (sp/g...) and
        dist (sp/g..., R), numpy float32, on the grid of the network output
        and cropped to the image; dist clamped at 1e-3. ``show_tile_progress``
        is taken so that calls written for the reference run; it shows
        nothing, as in the reference."""
        return tuple(t.cpu().numpy() for t in self._predict(img, axes, normalizer, n_tiles))

    def _predict(self, img, axes=None, normalizer=None, n_tiles=None, show_tile_progress=True):
        """:meth:`predict` as float32 tensors on ``self.device``."""
        x, axes_net, resizer, n_tiles = self._predict_setup(img, axes, normalizer, n_tiles)
        channel = axes_dict(axes_net)["C"]
        if np.prod(n_tiles) > 1:
            grid_dict = dict(zip(axes_net.replace("C", ""), self.config.grid))
            sh = [s // grid_dict.get(a, 1) for a, s in zip(axes_net, x.shape)]
            result = []
            for n_ch in (1, self.config.n_rays):
                sh[channel] = n_ch
                result.append(torch.empty(sh, dtype=torch.float32, device=self.device))
            for tile, s_src, s_dst in self._tiles(x, axes_net, n_tiles):
                for part, part_tile in zip(result, self._forward(tile)):
                    part[tuple(s_dst)] = part_tile[tuple(s_src)]
        else:
            result = self._forward(x)
        prob, dist = (resizer.after(part, axes_net) for part in result)
        prob = prob.select(channel, 0)
        dist = torch.movedim(dist.clamp_min(1e-3), channel, -1)
        return prob, dist

    def _forward(self, x):
        """Forward of one (sp..., C) numpy input -> channels-last tensors on
        ``self.device`` (prob (sp'..., 1), dist (sp'..., R))."""
        prob, dist = self.net(self._upload(x))
        return prob[..., None], torch.movedim(dist, 0, -1)

    def predict_instances(self, img, axes=None, normalizer=None, sparse=True, prob_thresh=None,
                          nms_thresh=None, scale=None, n_tiles=None, show_tile_progress=True,
                          verbose=False, return_labels=True, predict_kwargs=None,
                          nms_kwargs=None, overlap_label=None, return_predict=False, *, b=2,
                          fetch=True):
        """Predict -> NMS -> rasterize, with the reference's parameters
        (base.py:1479-1571). Returns (labels (*sp) int32 numpy, details
        dict: the survivors (see the model's ``_render_survivors``),
        ``nms_counters`` and the stage times ``timings_s``); with
        ``return_predict``, ``((labels, details), (prob, dist))``, the dense
        maps of :meth:`predict` (it sets ``sparse=False``, with a warning).

        ``img`` and ``n_tiles`` as in :meth:`_predict_sparse`;
        ``show_tile_progress`` as in :meth:`predict`; ``b`` is the
        candidates' border. ``sparse=False`` thresholds the dense maps of
        :meth:`predict`, kept on ``self.device`` (the model's
        ``_nms_dense``), instead of extracting candidates. ``scale`` (a
        number for every spatial axis, or one per axis of ``img``) zooms the
        image on the host (``scipy.ndimage.zoom``, order 1) before the
        prediction and draws the labels at the image's own shape.
        ``predict_kwargs`` go to the candidate extraction (``b``,
        ``max_candidates``, ``device_dist``: in one tile, whether the
        padding leaves the mask before the top-K, the default, or its
        candidates are dropped after it; see :meth:`_predict_sparse`) or to
        :meth:`predict`; ``nms_kwargs`` to the NMS (``b``, ``use_bbox``,
        ``use_kdtree``, ``verbose``). ``fetch=False`` (2D) leaves the labels
        and the survivors as tensors on ``self.device``. ``overlap_label``
        raises ``NotImplementedError`` when set (the reference's 2D model
        does the same)."""
        if overlap_label is not None:
            raise NotImplementedError("predict_instances(overlap_label=...) is not ported yet")
        predict_kwargs = dict(predict_kwargs or {})
        nms_kwargs = dict(nms_kwargs or {})
        if return_predict and sparse:
            sparse = False
            warnings.warn("Setting sparse to False because return_predict is True")
        nms_kwargs.setdefault("verbose", verbose)
        shape_inst = self._shape_inst(img, axes)
        if scale is not None:
            img, scale = self._zoom(img, axes, scale, verbose)
        timings = {}
        if sparse:
            predict_kwargs.setdefault("b", b)
            fold_padding = bool(predict_kwargs.pop("device_dist", True))
            prob, dist, points = self._predict_sparse(img, prob_thresh, axes, normalizer,
                                                      n_tiles, timings=timings,
                                                      fold_padding=fold_padding, **predict_kwargs)
        else:
            nms_kwargs.setdefault("b", b)
            t0 = time.perf_counter()
            prob, dist = self._predict(img, axes, normalizer, n_tiles, show_tile_progress,
                                       **predict_kwargs)
            _sync(self.device)
            timings.update(forward=time.perf_counter() - t0)
            points = None
        res = self._instances_from_prediction(
            shape_inst, prob, dist, points, prob_thresh=prob_thresh, nms_thresh=nms_thresh,
            scale=scale, return_labels=return_labels, timings=timings,
            render_kw=dict(fetch=fetch), **nms_kwargs)
        res[1]["timings_s"] = timings
        if return_predict:
            return res, (prob.cpu().numpy(), dist.cpu().numpy())
        return res

    def _shape_inst(self, img, axes):
        """The label image's shape: the spatial axes of ``img`` in the
        model's axes order."""
        if isinstance(img, torch.Tensor):
            return tuple(int(s) for s in img.shape[:self.config.n_dim])
        _axes = self._normalize_axes(img, axes)
        x_shape = move_image_axes(img, _axes, self.config.axes, adjust_singletons=True).shape
        return tuple(s for s, a in zip(x_shape, self.config.axes) if a != "C")

    def _zoom(self, img, axes, scale, verbose=False):
        """``img`` zoomed by ``scale`` on the host, as the reference does
        (base.py:1507-1521), and the scale as a dict of the axes of ``img``,
        checked by the model's ``_rescale``."""
        from scipy import ndimage as ndi
        if isinstance(img, torch.Tensor):
            raise ValueError("scale needs a numpy image")
        _axes = self._normalize_axes(img, axes)
        if isinstance(scale, numbers.Number):
            scale = tuple(scale if a in "XYZ" else 1 for a in _axes)
        scale = tuple(scale)
        if len(scale) != len(_axes):
            raise ValueError(f"scale {scale} must be of length {len(_axes)}")
        for s, a in zip(scale, _axes):
            if not s > 0:
                raise ValueError("scale values must be greater than 0")
            if not (s in (1, None) or a in "XYZ"):
                warnings.warn(f"replacing scale value {s} for non-spatial axis {a} with 1")
        scale = tuple(s if a in "XYZ" else 1 for s, a in zip(scale, _axes))
        scale_dict = dict(zip(_axes, scale))
        self._rescale(scale_dict)
        if verbose:
            print(f"scaling image by factors {scale} for axes {_axes}")
        return ndi.zoom(img, scale, order=1), scale_dict

    def _instances_from_prediction(self, img_shape, prob, dist, points, prob_thresh=None,
                                   nms_thresh=None, scale=None, return_labels=True,
                                   timings=None, render_kw=None, **nms_kwargs):
        """NMS + rasterization -> (labels, details); reference
        model2d.py:512-563 and model3d.py:314-359. ``points=None``: the
        dense maps (prob (sp...), dist (sp..., R) on ``self.device``), else
        a candidate list. ``scale``, a dict of the image's axes, scales the
        survivors back to the image (the model's ``_rescale``).
        ``timings["raster"]`` includes the copy back to the host."""
        if prob_thresh is None:
            prob_thresh = self.thresholds.prob
        if nms_thresh is None:
            nms_thresh = self.thresholds.nms
        render_kw = dict(render_kw or {})
        if scale is not None:
            render_kw["rescale"] = self._rescale(scale)
        counters = {}
        t0 = time.perf_counter()
        if points is None:
            nms = self._nms_dense(dist, prob, prob_thresh, nms_thresh, stats=counters,
                                  **nms_kwargs)
        else:
            nms = self._nms_sparse(dist, prob, points, nms_thresh, stats=counters, **nms_kwargs)
        points, probi, disti = nms[:3]
        _sync(self.device)
        t1 = time.perf_counter()
        labels, details = self._render_survivors(img_shape, disti, points, probi,
                                                 return_labels=return_labels, **render_kw)
        if timings is not None:
            timings.update(nms=t1 - t0, raster=time.perf_counter() - t1)
        details["nms_counters"] = counters
        return labels, details

    def optimize_thresholds(self, X_val, Y_val, nms_threshs=(0.3, 0.4, 0.5),
                            iou_threshs=(0.3, 0.5, 0.7), predict_kwargs=None,
                            optimize_kwargs=None, save_to_json=True, *, timings=None):
        """For each of ``nms_threshs``, the golden-section search of
        ``utils.optimize_threshold`` over prob_thresh on the dense
        predictions of ``X_val`` (``n_tiles`` from :meth:`_guess_n_tiles`
        unless ``predict_kwargs`` names it), keeping the pair of the best
        mean matching score against ``Y_val`` (reference base.py:1657-1691).
        Sets ``self.thresholds``, writes ``thresholds.json`` into the model
        folder when it has one and ``save_to_json`` is set, and returns the
        dict. ``timings``, if a dict, receives the seconds of the predictions
        (``predict``) and of the search's stages (see
        ``utils.optimize_threshold``)."""
        predict_kwargs = {} if predict_kwargs is None else predict_kwargs
        optimize_kwargs = {} if optimize_kwargs is None else optimize_kwargs

        def _predict_kwargs(x):
            if "n_tiles" in predict_kwargs:
                return predict_kwargs
            return {**predict_kwargs, "n_tiles": self._guess_n_tiles(x), "show_tile_progress": False}

        t0 = time.perf_counter()
        Yhat_val = [self.predict(x, **_predict_kwargs(x))[:2] for x in X_val]
        if timings is not None:
            timings["predict"] = time.perf_counter() - t0

        opt_prob_thresh, opt_measure, opt_nms_thresh = None, -np.inf, None
        for _opt_nms_thresh in nms_threshs:
            _opt_prob_thresh, _opt_measure = optimize_threshold(
                Y_val, Yhat_val, model=self, nms_thresh=_opt_nms_thresh,
                iou_threshs=list(iou_threshs), timings=timings, **optimize_kwargs)
            if _opt_measure > opt_measure:
                opt_prob_thresh, opt_measure, opt_nms_thresh = (
                    _opt_prob_thresh, _opt_measure, _opt_nms_thresh)
        opt_threshs = dict(prob=float(opt_prob_thresh), nms=float(opt_nms_thresh))

        self.thresholds = Thresholds(**opt_threshs)
        print("Using optimized values: prob_thresh={prob:g}, nms_thresh={nms:g}.".format(
            prob=self.thresholds.prob, nms=self.thresholds.nms))
        if save_to_json and self.basedir is not None:
            print("Saving to 'thresholds.json'.")
            with open(self.logdir / "thresholds.json", "w") as f:
                json.dump(opt_threshs, f)
        return opt_threshs

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
        base.py:1704-1730). A net whose output ignores the delta (all-zero
        weights, say) is replaced by a freshly initialised one (seeded)."""
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

    def _nms_sparse(self, dist, prob, points, nms_thresh, stats=None, **nms_kwargs):
        raise NotImplementedError()

    def _nms_dense(self, dist, prob, prob_thresh, nms_thresh, stats=None, **nms_kwargs):
        raise NotImplementedError()

    def _rescale(self, scale):
        raise NotImplementedError()

    def _nms_keep(self, prob, dist, points, nms_thresh):
        raise NotImplementedError()

    def _render_survivors(self, img_shape, disti, points, probi, return_labels=True,
                          fetch=True):
        raise NotImplementedError()
