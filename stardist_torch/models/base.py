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
until the epoch ends. Under a ``torch.distributed`` process group whose
world size divides the batch, each rank takes its rows of the same batch
and the update is the one-process update of the whole batch (data-parallel
training, :meth:`StarDistBase._train_step`); only rank 0 writes files.

Weights: the reference's flax checkpoints (``models/weights.py``) and Keras
HDF5 files of upstream StarDist's model zoo (:meth:`StarDistBase.
_import_keras_h5`).

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
import functools
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
import torch.distributed as dist

from ..core.axes import axes_check_and_normalize, axes_dict, move_image_axes
from ..core.normalize import NoNormalizer, Normalizer
from ..core.profiling import span
from ..core.tiling import tile_iterator
from ..parallel.mesh import (broadcast_numpy_rng, broadcast_parameters, data_parallel_slice,
                             world)
from ..sample_patches import get_valid_inds
from ..utils import _is_power_of_2, grid_divisible_patch_size, optimize_threshold
from . import losses as L
from .unet import BN_TRAINING, StarDistNet
from .weights import (load_flax_variables, params_from_flax, params_to_flax,
                      save_flax_checkpoint)

INIT_SEED = 42           # a fresh model's weights, as the reference's
METRICS = ("loss", "prob_loss", "dist_loss", "prob_kld", "dist_relevant_mae",
           "dist_relevant_mse", "dist_dist_iou_metric")
METRICS_MULTICLASS = METRICS + ("prob_class_loss",)


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


def _class_details(prob_class, fetch=True):
    """The details' ``class_prob`` (the survivors' class rows) and
    ``class_id`` (their argmax, the first class on ties) of a multiclass
    prediction (reference model2d.py:380-382): numpy with ``fetch``, else
    tensors where ``prob_class`` is; nothing without a class map."""
    if prob_class is None:
        return {}
    if not fetch:
        return dict(class_prob=prob_class, class_id=torch.argmax(prob_class, dim=-1))
    prob_class = prob_class.cpu().numpy()
    return dict(class_prob=prob_class, class_id=np.argmax(prob_class, axis=-1))


def _drain(generator):
    """A method that runs the generator method ``generator`` to its end and
    returns its last yield (the reference's ``predict``, ``predict_sparse``
    and ``predict_instances``, base.py:1368-1571); it takes the
    generator's signature and docstring. The whole call is the root span
    ``stardist.<method>`` (:class:`..core.profiling.span`) of the stage
    spans inside it."""
    root = "stardist." + generator.__name__.strip("_").removesuffix("_generator")

    @functools.wraps(generator)
    def drain(self, *args, **kwargs):
        r = None
        with span(root):
            for r in generator(self, *args, **kwargs):
                pass
        return r
    return drain


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

    def __init__(self, config=None, name=None, basedir=".", *, device="cuda",
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
        self._batch_rows = None          # this rank's rows of a batch (prepare_for_training)
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
        self.thresholds = dict(prob=prob if prob is not None and 0 < prob < 1 else 0.5,
                               nms=nms if nms is not None and 0 < nms < 1 else 0.4)
        self.net.to(self.device)

    @property
    def thresholds(self):
        """The default (prob, nms) thresholds, a namedtuple ``Thresholds``."""
        return self._thresholds

    @thresholds.setter
    def thresholds(self, d):
        """A dict or a namedtuple is stored as a namedtuple of its keys, as
        the reference stores it (base.py:361-366)."""
        d = d._asdict() if hasattr(d, "_asdict") else dict(d)
        self._thresholds = namedtuple("Thresholds", d.keys())(*d.values())

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
        """Load a flax msgpack checkpoint (the reference's ``.h5`` files:
        ``params``, and ``batch_stats`` for a batch-norm net) or a Keras
        HDF5 weights file (upstream StarDist's; read by
        :meth:`_import_keras_h5`, which needs ``h5py``): ``name`` in the
        model folder, or an absolute path."""
        path = Path(name) if Path(name).is_absolute() else self.logdir / name
        with open(path, "rb") as f:
            keras = f.read(4) == b"\x89HDF"
        if keras:
            sd = self._import_keras_h5(path)
        else:
            tree = load_flax_variables(path)
            sd = params_from_flax(self.net, tree["params"], tree.get("batch_stats"))
        self.net.load_state_dict(sd)
        self.net.to(self.device)

    def _keras_conv_slots(self):
        """The net's conv modules as paths into the flax parameter tree
        (:func:`.weights.params_to_flax`), in the order of the forward,
        which is the order of the reference's Keras build; and the paths of
        the layers upstream StarDist names (``features``, ``prob``,
        ``dist``, ``features_class``, ``prob_class``). The U-Net backbone
        only, without batch norm, as the reference's import
        (base.py:482-535)."""
        cfg = self.config
        if str(cfg.backbone).lower() != "unet":
            raise NotImplementedError("Keras HDF5 import currently supports the unet backbone only")
        if cfg.unet_batch_norm:
            raise NotImplementedError("Keras HDF5 import with batch_norm is not supported yet")
        grid, n_conv = tuple(cfg.grid), cfg.unet_n_conv_per_depth
        slots, outer = [], 0
        pooled = np.ones(len(grid), int)
        while tuple(pooled) != grid:                     # the grid's pre-pooling convs
            pooled *= 1 + (np.asarray(grid) > pooled)
            for _ in range(n_conv):
                slots.append((f"ConvBlock_{outer}", "Conv_0"))
                outer += 1
        for inner in range((2 * cfg.unet_n_depth + 1) * n_conv):   # down, middle, up
            slots.append(("UNetBackbone_0", f"ConvBlock_{inner}", "Conv_0"))
        named = {}
        if cfg.net_conv_after_unet > 0:
            named["features"] = (f"ConvBlock_{outer}", "Conv_0")
            slots.append(named["features"])
            outer += 1
        named["prob"], named["dist"] = ("head_prob",), ("head_dist",)
        slots += [named["prob"], named["dist"]]
        if self._is_multiclass():
            if cfg.net_conv_after_unet > 0:
                named["features_class"] = (f"ConvBlock_{outer}", "Conv_0")
                slots.append(named["features_class"])
            named["prob_class"] = ("head_prob_class",)
            slots.append(named["prob_class"])
        return slots, named

    def _import_keras_h5(self, path):
        """The state dict of a Keras ``save_weights`` HDF5 file (the layout
        of upstream StarDist's zoo, its csbdeep U-Net) for this net
        (reference base.py:537-599). The layers upstream StarDist names are
        placed by name; the other conv layers fill the net's remaining conv
        slots in the order of the forward, with a shape check at every
        slot. The weights go through the flax parameter tree, so they land
        on exactly the tensors :func:`.weights.params_from_flax` makes of
        the reference's import."""
        import h5py

        def text(v):
            return v.decode() if isinstance(v, bytes) else v

        with h5py.File(path, "r") as f:
            g = f["model_weights"] if "model_weights" in f else f
            if "layer_names" not in g.attrs:
                raise ValueError(f"not a Keras weights HDF5 file: {path}")
            entries = []
            for ln in map(text, g.attrs["layer_names"]):
                wnames = [text(n) for n in g[ln].attrs.get("weight_names", [])]
                if wnames:
                    entries.append((ln, [np.asarray(g[ln][wn]) for wn in wnames]))

        slots, named = self._keras_conv_slots()
        assign, anon = {}, []
        for ln, ws in entries:
            if len(ws) != 2:
                raise NotImplementedError(f"layer '{ln}' has {len(ws)} weights; only conv "
                                          "kernel+bias layers are supported")
            if ln in named:
                assign[named[ln]] = ws
            else:
                anon.append((ln, ws))
        open_slots = [s for s in slots if s not in assign]
        if len(anon) != len(open_slots):
            raise ValueError(f"Keras file has {len(anon)} unnamed conv layers but the network "
                             f"expects {len(open_slots)} ({[ln for ln, _ in anon]} vs "
                             f"{open_slots})")
        assign.update(zip(open_slots, (ws for _, ws in anon)))

        params = params_to_flax(self.net)
        for slot, (kernel, bias) in assign.items():
            node = params
            for k in slot:
                node = node[k]
            if node["kernel"].shape != kernel.shape or node["bias"].shape != bias.shape:
                raise ValueError(f"shape mismatch at {slot}: network {node['kernel'].shape}/"
                                 f"{node['bias'].shape} vs h5 {kernel.shape}/{bias.shape}")
            node["kernel"] = np.asarray(kernel, np.float32)
            node["bias"] = np.asarray(bias, np.float32)
        return params_from_flax(self.net, params)

    def save_weights(self, name="weights_best.h5"):
        """Write the weights (and a batch-norm net's statistics) into the
        model folder as the reference's flax checkpoint, which both packages
        load."""
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
        0.999, eps 1e-8), the targets function of the training step and,
        under a process group, the data parallelism (reference base.py:
        733-740): every rank takes rank 0's weights, and when the world size
        divides ``train_batch_size`` each step runs this rank's rows of the
        batch (``_batch_rows``), else the whole batch on every rank. A
        batch-norm net raises ``NotImplementedError``: the reference cannot
        train one (``unet.BN_TRAINING``)."""
        if self.net.batch_norm:
            raise NotImplementedError(BN_TRAINING)
        if optimizer is None:
            optimizer = torch.optim.Adam(self.net.parameters(), lr=self.config.train_learning_rate,
                                         betas=(0.9, 0.999), eps=1e-8)
        self.optimizer = optimizer
        self._targets_fn = self._device_targets_fn()
        self._batch_rows = data_parallel_slice(self.config.train_batch_size)
        broadcast_parameters(self.net)
        self._model_prepared = True

    def _metric_names(self):
        """The training metrics in the order of the reference's dict (the
        class loss last for a multiclass model)."""
        return METRICS_MULTICLASS if self._is_multiclass() else METRICS

    def _shard(self, batch):
        """The whole batch's loss normalizers (:class:`.losses.Shard`) for a
        target batch that holds this rank's rows of it: the rows' counts
        summed over the ranks by one all-reduce (the targets carry no
        gradient)."""
        n_rays, total = self.config.n_rays, self.config.train_batch_size
        prob_true, dist_mask = batch["prob"][..., 0], batch["dist"][..., n_rays:]
        sums = torch.stack([torch.sum((prob_true >= 0).to(prob_true.dtype)), torch.sum(dist_mask)])
        dist.all_reduce(sums, group=world()[2])
        rows = len(prob_true)
        return L.Shard(prob_mask_sum=sums[0], dist_mask_mean=sums[1] / (dist_mask.numel() *
                                                                         total // rows),
                       share=rows / total)

    def _loss_and_metrics(self, batch, generator=None, rows=None):
        """(loss, metrics dict) of a target batch ``{"x", "prob", "dist"}``
        (and ``"prob_class"`` for a multiclass model) on the device; the
        metrics are computed without autograd. ``rows``: the batch holds
        these rows (a slice) of a batch of ``train_batch_size`` split over
        the ranks; the loss and metrics are then this rank's shares of the
        whole batch's (:meth:`_shard`), which the ranks sum."""
        cfg = self.config
        w = tuple(cfg.train_loss_weights)
        n_rays = cfg.n_rays
        shard = None if rows is None else self._shard(batch)
        outs = self.net.train_forward(batch["x"], generator,
                                      None if rows is None else (rows, cfg.train_batch_size))
        prob_pred, dist_pred = outs[:2]
        prob_true, dist_true = batch["prob"][..., 0], batch["dist"][..., :n_rays]
        dist_mask = batch["dist"][..., n_rays:]
        lp = L.prob_loss(prob_true, prob_pred[..., 0], shard)
        ld = L.dist_loss(dist_true, dist_mask, dist_pred, kind=cfg.train_dist_loss,
                         reg_weight=float(cfg.train_background_reg), shard=shard)
        loss = w[0] * lp + w[1] * ld
        with torch.no_grad():
            p, d = prob_pred.detach()[..., 0], dist_pred.detach()
            metrics = {"loss": loss.detach(), "prob_loss": lp.detach(), "dist_loss": ld.detach(),
                       "prob_kld": L.kld_metric(prob_true, p, shard),
                       "dist_relevant_mae": L.relevant_mae(dist_true, dist_mask, d, shard),
                       "dist_relevant_mse": L.relevant_mse(dist_true, dist_mask, d, shard),
                       "dist_dist_iou_metric": L.dist_iou_metric(dist_true, dist_mask, d, shard)}
        if self._is_multiclass():
            lc = L.class_loss(batch["prob_class"], outs[2], tuple(cfg.train_class_weights),
                              shard)
            loss = loss + w[2] * lc
            metrics["loss"] = loss.detach()
            metrics["prob_class_loss"] = lc.detach()
        return loss, metrics

    def _put_batch(self, batch, shard=False):
        """A batch's arrays as tensors on the device (non-blocking from
        pinned memory); other entries as they are. ``shard``: only this
        rank's rows of a training batch (``_batch_rows``), where the batch
        is split over the ranks."""
        rows = self._batch_rows if shard else None

        def put(v):
            t = torch.as_tensor(v)
            return (t if rows is None else t[rows]).to(self.device, non_blocking=True)
        return {k: (put(v) if isinstance(v, (np.ndarray, torch.Tensor)) else v)
                for k, v in batch.items()}

    def _train_step(self, batch, generator=None, marks=None):
        """One update from a device batch (raw: targets built first) ->
        the metrics as one tensor on the device, in the order of
        :meth:`_metric_names`. Where the batch is this rank's rows
        (``_batch_rows``), the ranks' gradients and metrics are summed
        before the update (:meth:`_all_reduce_grads`).
        ``marks(stage)``, where given, is called as each stage is issued."""
        rows = self._batch_rows
        if "y" in batch:
            batch = self._targets_fn(batch)
        if marks is not None:
            marks("targets")
        loss, metrics = self._loss_and_metrics(batch, generator, rows)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if marks is not None:
            marks("forward+backward")
        out = torch.stack([metrics[k] for k in self._metric_names()])
        if rows is not None:
            out = self._all_reduce_grads(out)
            if marks is not None:
                marks("all-reduce")
        self.optimizer.step()
        if marks is not None:
            marks("optimizer")
        return out

    def _all_reduce_grads(self, metrics):
        """Sum the ranks' gradients and ``metrics`` (a 1-d tensor) in one
        all-reduce of one flat buffer; returns the summed metrics.

        By hand, not ``DistributedDataParallel``: DDP averages the ranks'
        gradients, which is right for a loss that is a mean of per-sample
        means. This loss is not (its normalizers are masked sums over the
        whole batch); each rank's loss is already its share of the whole
        batch's loss (:meth:`_shard`), so the whole batch's gradient is the
        sum of the ranks' gradients, and the metrics ride in the same
        buffer."""
        params = list(self.net.parameters())
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params] + [metrics])
        dist.all_reduce(flat, group=world()[2])
        off = 0
        for p in params:
            g = flat[off:off + p.numel()].view_as(p)
            p.grad = g.clone() if p.grad is None else p.grad.copy_(g)
            off += p.numel()
        return flat[off:]

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
        run would. Under a process group every rank runs this loop on the
        same data stream; only rank 0 writes the logs, the checkpoints and
        ``train_state.pt``."""
        cfg = self.config
        writes = self.basedir is not None and world()[0] == 0
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
        if writes:
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

        # every rank draws rank 0's stream (here, after the TensorBoard
        # writer: importing it may reseed numpy's global RNG)
        broadcast_numpy_rng()
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        trackers = dict(best_ckpt=best_ckpt, best_plateau=best_plateau,
                        plateau_wait=plateau_wait, lr=lr)
        try:
            self._fit_epochs(epochs, steps_per_epoch, prefetch_q, generator, history, jsonl_path,
                             tb_writer, trackers, factor, patience, min_delta, rlrop, val_batch,
                             start_epoch, epoch_np_rng, epoch_np_rng_lock, writes)
        finally:
            if tb_writer is not None:
                tb_writer.close()
            stop.set()
            thread.join()
        if writes:
            self._training_finished()
        return history

    def _tb_log_images(self, tb_writer, val_batch, step, n_images=3):
        """TensorBoard panels of the validation batch: input, true and
        predicted object probability, three evenly spaced rays of the
        predicted distances (the inference route's forward); of a volume,
        its middle z-slice."""
        x = val_batch["x"][:n_images]
        preds = [self.net(xi) for xi in x]
        prob_p = torch.stack([p[0] for p in preds])[..., None]
        dist_p = torch.stack([p[1].movedim(0, -1) for p in preds])
        n_rays = self.config.n_rays
        k = n_rays // min(3, n_rays)
        groups = {"input": x[..., :1], "prob/true": val_batch["prob"][:n_images, ..., :1],
                  "prob/pred": prob_p, "dist/pred": dist_p[..., 0:k * min(3, n_rays):k]}
        if self._is_multiclass():                            # class 1's probability
            groups["class/pred"] = torch.stack([p[2][1] for p in preds])[..., None]
        for name, g in groups.items():
            g = g.float().cpu().numpy()
            if g.ndim == 5:                                   # (B, Z, Y, X, C): the middle z
                g = g[:, g.shape[1] // 2]
            for i in range(g.shape[0]):
                for c in range(g.shape[-1]):
                    img = g[i, ..., c]
                    lo, hi = float(img.min()), float(img.max())
                    img = (img - lo) / (hi - lo) if hi > lo else img * 0
                    tag = name if g.shape[-1] == 1 else f"{name}/ch{c}"
                    tb_writer.add_image(f"{tag}/{i}", img[None], step)

    def _fit_epochs(self, epochs, steps_per_epoch, prefetch_q, generator, history, jsonl_path,
                    tb_writer, trackers, factor, patience, min_delta, rlrop, val_batch,
                    start_epoch, epoch_np_rng, epoch_np_rng_lock, writes):
        cfg = self.config
        rank, n_ranks, group = world()
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
                batch = self._put_batch(batch, shard=True)
                if marks is not None:
                    marks("upload")
                steps.append(self._train_step(batch, generator, marks))
            per_step = torch.stack(steps).cpu().numpy()           # the epoch's one readback
            names = self._metric_names()
            for j, k in enumerate(names):
                history.steps.setdefault(k, []).extend(per_step[:, j].tolist())
            logs = {k: float(np.mean(per_step[:, j])) for j, k in enumerate(names)}
            logs["lr"] = lr
            if val_batch is not None:
                with torch.no_grad():
                    _, val_metrics = self._loss_and_metrics(val_batch, generator)
                logs.update({f"val_{k}": float(v) for k, v in val_metrics.items()})
            if n_ranks > 1:                   # every rank takes rank 0's decisions
                shared = [logs]
                dist.broadcast_object_list(shared, src=0, group=group)
                logs = shared[0]
            history.append(logs)
            monitor = logs.get("val_loss", logs["loss"])
            if rank == 0:
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

            if writes:
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
                    if rank == 0:
                        print(f"ReduceLROnPlateau: reducing learning rate to {lr:g}", flush=True)

            if writes:
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
        with span("stardist.upload"):
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
    def _extract(prob, dist, prob_thresh, b_key, max_candidates=None, prob_class=None):
        """Candidates above ``prob_thresh`` and inside the border: (prob (K,),
        dist (K, R) clamped at 1e-3, points (K, n_dim) in output-grid units),
        and with a class map ``prob_class`` (C, *sp) its candidates' rows
        (K, C), gathered as the dist rows are (reference base.py:1160-1167).

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
        if prob_class is None:
            return vals, d, points
        return vals, d, points, prob_class.reshape(prob_class.shape[0], -1)[:, idx].t()

    def _predict_sparse_generator(self, img, prob_thresh=None, axes=None, normalizer=None,
                                  n_tiles=None, show_tile_progress=True, b=2,
                                  max_candidates=None, device_dist=False, *, timings=None,
                                  fetch=True, **predict_kwargs):
        """Sparse prediction (reference base.py:1375-1477), as a generator:
        it yields None after each tile's candidates (tiled calls only), then
        the result. :meth:`predict_sparse` runs it to its end.

        The result: numpy (prob (K,) float32, dist (K, R) float32, points
        (K, n_dim) int64), points in full-resolution pixels, and for a
        multiclass model (prob, dist, prob_class (K, n_classes + 1)
        float32, points), the reference's order; ``fetch=False`` leaves all
        of them tensors on ``self.device``.

        ``img`` is a numpy image, or a pre-staged tensor on ``self.device``
        (see :meth:`_prestaged`). With ``n_tiles`` (one count per axis of
        ``img``) each tile's candidates are those of its core, minus the
        border ``b`` at the image's edges; the lists are joined in tile
        order, each in its tile's ``top_k`` order (reference
        base.py:1395-1432), and candidates in the padding are dropped.
        ``max_candidates`` keeps the top-K of each tile (of the padded image
        when it is one tile), with a warning when there were more, as the
        reference's default route does. ``device_dist=True`` is the
        reference's device route: in one tile the padding leaves the mask
        before the top-K instead of its candidates being dropped after the
        extraction (the two differ only in what ``max_candidates`` keeps),
        and with ``fetch`` ``dist`` stays a tensor on ``self.device`` (a
        CUDA tensor on the card), the rest numpy; tiled, everything is
        numpy, as in the reference (base.py:1444-1460).
        ``show_tile_progress`` shows nothing and ``predict_kwargs`` are
        taken and change nothing, as in the reference. ``timings``, if a
        dict, receives the seconds of the forwards (``forward``) and of the
        extraction (``extract``), neither counting the time the caller
        holds a yield."""
        if prob_thresh is None:
            prob_thresh = self.thresholds.prob
        with span("stardist.prepare"):
            if isinstance(img, torch.Tensor):
                x = self._prestaged(img, axes, normalizer, n_tiles)
                axes_net, resizer, n_tiles = self.config.axes, None, (1,) * x.dim()
            else:
                x, axes_net, resizer, n_tiles = self._predict_setup(img, axes, normalizer,
                                                                    n_tiles)
            grid = torch.tensor(self.config.grid, device=self.device)
        if timings is not None:
            timings.update(forward=0.0, extract=0.0)
        one_tile = np.prod(n_tiles) == 1
        if not one_tile:
            sp = [i for i, a in enumerate(axes_net) if a != "C"]
            out_sh = [x.shape[i] // g for i, g in zip(sp, self.config.grid)]
            bb = 0 if b is None else b
            parts = []
            for tile, s_src, s_dst in self._tiles(x, axes_net, n_tiles):
                s_src = [s_src[i] for i in sp]
                s_dst = [s_dst[i] for i in sp]
                with span("stardist.forward", timings, "forward"):
                    outs = self.net(self._upload(tile))
                    _sync(self.device)
                with span("stardist.extract", timings, "extract"):
                    b_key = tuple((s_s.start + (bb if s_d.start == 0 else 0),
                                   (t_len - s_s.stop) + (bb if s_d.stop == sh else 0))
                                  for s_s, s_d, t_len, sh in zip(s_src, s_dst, outs[0].shape,
                                                                 out_sh))
                    vals, d, points, *pc = self._extract(outs[0], outs[1], float(prob_thresh),
                                                         b_key, max_candidates, *outs[2:])
                    offset = torch.tensor([s_d.start - s_s.start
                                           for s_s, s_d in zip(s_src, s_dst)], device=self.device)
                    parts.append((vals, d, (points + offset) * grid, *pc))
                    _sync(self.device)
                del outs
                yield
            with span("stardist.extract", timings, "extract"):
                vals, d, points, *pc = (torch.cat(t) for t in zip(*parts))
                inside = torch.all(points < self._inside_bounds(axes_net, resizer), dim=1)
                vals, d, points = vals[inside], d[inside], points[inside]
                pc = [c[inside] for c in pc]
                _sync(self.device)
        else:
            if device_dist or resizer is None:
                b_key = self._border_key(b, x, axes_net, resizer)
            else:
                b_key = (b if b is not None and not np.isscalar(b)
                         else ((-1, -1) if b is None else (b, b),) * len(self.config.grid))
            with span("stardist.forward", timings, "forward"):
                outs = self.net(self._upload(x))
                _sync(self.device)
            with span("stardist.extract", timings, "extract"):
                vals, d, points, *pc = self._extract(outs[0], outs[1], float(prob_thresh), b_key,
                                                     max_candidates, *outs[2:])
                points = points * grid[None]
                if not device_dist and resizer is not None:
                    inside = torch.all(points < self._inside_bounds(axes_net, resizer), dim=1)
                    vals, d, points = vals[inside], d[inside], points[inside]
                    pc = [c[inside] for c in pc]
                _sync(self.device)
        out = (vals, d, *pc, points)
        if fetch:
            out = tuple(t if device_dist and one_tile and i == 1 else t.cpu().numpy()
                        for i, t in enumerate(out))
        yield out

    predict_sparse = _drain(_predict_sparse_generator)

    def _predict_sparse(self, img, prob_thresh=None, axes=None, normalizer=None,
                        n_tiles=None, b=2, timings=None, max_candidates=None,
                        fold_padding=True):
        """:meth:`predict_sparse` as tensors on ``self.device``, with
        ``fold_padding`` for its ``device_dist`` (default True, the route
        of :meth:`predict_instances`)."""
        return self.predict_sparse(img, prob_thresh, axes, normalizer, n_tiles, b=b,
                                   max_candidates=max_candidates, device_dist=fold_padding,
                                   timings=timings, fetch=False)

    def _inside_bounds(self, axes_net, resizer):
        """Per spatial axis, the end of the image within the padded input
        (full-resolution pixels): the reference's ``filter_points``."""
        return torch.tensor([resizer.padded_shape[a] - resizer.pad[a][1]
                             for a in axes_net if a != "C"], device=self.device)

    def _predict_generator(self, img, axes=None, normalizer=None, n_tiles=None,
                           show_tile_progress=True, *, fetch=True, **predict_kwargs):
        """Dense prediction (reference base.py:1325-1373), as a generator:
        it yields None after each tile (tiled calls only), then the result.
        :meth:`predict` runs it to its end.

        The result: prob (sp/g...) and dist (sp/g..., R), numpy float32, on
        the grid of the network output and cropped to the image; dist
        clamped at 1e-3; a multiclass model adds prob_class (sp/g...,
        n_classes + 1). ``fetch=False`` leaves them float32 tensors on
        ``self.device``. ``show_tile_progress`` shows nothing and
        ``predict_kwargs`` are taken and change nothing, as in the
        reference."""
        with span("stardist.prepare"):
            x, axes_net, resizer, n_tiles = self._predict_setup(img, axes, normalizer, n_tiles)
        channel = axes_dict(axes_net)["C"]
        if np.prod(n_tiles) > 1:
            grid_dict = dict(zip(axes_net.replace("C", ""), self.config.grid))
            sh = [s // grid_dict.get(a, 1) for a, s in zip(axes_net, x.shape)]
            result = []
            n_classes = self.config.n_classes
            extra = (n_classes + 1,) if n_classes is not None else ()
            for n_ch in (1, self.config.n_rays) + extra:
                sh[channel] = n_ch
                result.append(torch.empty(sh, dtype=torch.float32, device=self.device))
            for tile, s_src, s_dst in self._tiles(x, axes_net, n_tiles):
                for part, part_tile in zip(result, self._forward(tile)):
                    part[tuple(s_dst)] = part_tile[tuple(s_src)]
                yield
        else:
            result = self._forward(x)
        prob, dist, *pc = (resizer.after(part, axes_net) for part in result)
        prob = prob.select(channel, 0)
        dist = torch.movedim(dist.clamp_min(1e-3), channel, -1)
        out = (prob, dist, *(torch.movedim(c, channel, -1) for c in pc))
        yield tuple(t.cpu().numpy() for t in out) if fetch else out

    predict = _drain(_predict_generator)

    def _predict(self, img, axes=None, normalizer=None, n_tiles=None, show_tile_progress=True):
        """:meth:`predict` as float32 tensors on ``self.device``."""
        return self.predict(img, axes, normalizer, n_tiles, fetch=False)

    def _forward(self, x):
        """Forward of one (sp..., C) numpy input -> channels-last tensors on
        ``self.device`` (prob (sp'..., 1), dist (sp'..., R), and prob_class
        (sp'..., n_classes + 1) for a multiclass model)."""
        prob, *rest = self.net(self._upload(x))
        return (prob[..., None], *(torch.movedim(t, 0, -1) for t in rest))

    def _predict_instances_generator(self, img, axes=None, normalizer=None, sparse=True,
                                     prob_thresh=None, nms_thresh=None, scale=None,
                                     n_tiles=None, show_tile_progress=True, verbose=False,
                                     return_labels=True, predict_kwargs=None, nms_kwargs=None,
                                     overlap_label=None, return_predict=False, *, b=2,
                                     fetch=True):
        """Predict -> NMS -> rasterize, with the reference's parameters
        (base.py:1479-1571), as a generator: it yields ``"predict"``, then
        ``"tile"`` after each tile (tiled calls only, sparse and dense),
        then ``"nms"``, then the result; :meth:`predict_instances` runs it
        to its end (upstream's napari plugin drives the reference's for its
        tile progress bar). A generator made and never run does nothing.

        The result: (labels (*sp) int32 numpy, details dict: the survivors
        (see the model's ``_render_survivors``), ``nms_counters`` and the
        stage times ``timings_s``, none of which counts the time the caller
        holds a yield); with ``return_predict``, ``((labels, details),
        (prob, dist))``, the dense maps of :meth:`predict` (it sets
        ``sparse=False``, with a warning).

        ``img`` and ``n_tiles`` as in :meth:`predict_sparse`;
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
        candidates are dropped after it; see :meth:`predict_sparse`) or to
        :meth:`predict`; ``nms_kwargs`` to the NMS (``b``, ``use_bbox``,
        ``use_kdtree``, ``verbose``, and the reference's NMS options:
        ``samples``, the exact overlap test's resolution, and the
        scheduling options, which change nothing; see
        :mod:`stardist_torch.nms`). ``fetch=False`` leaves the labels and
        the survivors as tensors on ``self.device``. ``overlap_label`` (3D)
        marks the voxels that more than one survivor covers; the 2D model
        raises ``NotImplementedError`` for it, as the reference's 2D model
        does."""
        render_kw = dict(fetch=fetch)
        if overlap_label is not None:
            if self.config.n_dim == 2:
                raise NotImplementedError("overlap_label not supported for 2D yet!")
            render_kw["overlap_label"] = overlap_label
        predict_kwargs = dict(predict_kwargs or {})
        nms_kwargs = dict(nms_kwargs or {})
        if return_predict and sparse:
            sparse = False
            warnings.warn("Setting sparse to False because return_predict is True")
        nms_kwargs.setdefault("verbose", verbose)
        with span("stardist.prepare"):
            shape_inst = self._shape_inst(img, axes)
            if scale is not None:
                img, scale = self._zoom(img, axes, scale, verbose)
        timings = {}
        yield "predict"
        if sparse:
            predict_kwargs.setdefault("b", b)
            device_dist = bool(predict_kwargs.pop("device_dist", True))
            for res in self._predict_sparse_generator(
                    img, prob_thresh, axes, normalizer, n_tiles, show_tile_progress,
                    device_dist=device_dist, timings=timings, fetch=False, **predict_kwargs):
                if res is None:
                    yield "tile"
            *pred, points = res
        else:
            nms_kwargs.setdefault("b", b)
            steps = self._predict_generator(img, axes, normalizer, n_tiles, show_tile_progress,
                                            fetch=False, **predict_kwargs)
            # each step of the dense prediction (a tile, or the last one and its
            # result) is a forward span, closed before the caller gets the yield
            while True:
                with span("stardist.forward", timings, "forward"):
                    pred = next(steps)
                    if pred is not None:
                        _sync(self.device)
                if pred is not None:
                    break
                yield "tile"
            points = None
        yield "nms"
        prob, dist, *pc = pred
        res = self._instances_from_prediction(
            shape_inst, prob, dist, points, *pc, prob_thresh=prob_thresh, nms_thresh=nms_thresh,
            scale=scale, return_labels=return_labels, timings=timings,
            render_kw=render_kw, **nms_kwargs)
        res[1]["timings_s"] = timings
        if return_predict:
            yield res, tuple(t.cpu().numpy() for t in pred)
        else:
            yield res

    predict_instances = _drain(_predict_instances_generator)

    def predict_instances_big(self, img, axes, block_size, min_overlap, context=None,
                              labels_out=None, labels_out_dtype=np.int32, show_progress=True,
                              **kwargs):
        """Block-wise :meth:`predict_instances` of an image too big for one
        call (reference base.py:1573-1656): ``img`` is cut into overlapping
        blocks (``big.BlockND.cover``; ``block_size``, ``min_overlap`` and
        ``context`` per axis of ``axes`` or one for all, made divisible by
        the network stride; ``context`` defaults to the tile overlap);
        each block is predicted on ``self.device``, its context cropped, and
        only the objects it is responsible for are kept, relabelled after
        the previous blocks' and written into ``labels_out`` (a new array
        of ``labels_out_dtype`` by default, a given one of the model's
        spatial shape, or none when ``labels_out=False``). ``kwargs`` go to
        :meth:`predict_instances`; ``axes``, ``overlap_label``,
        ``return_labels`` and ``return_predict`` are set here, with a
        message where the caller set them. Returns (labels_out, details):
        the object keys of ``big.OBJECT_KEYS`` (a multiclass model's
        ``class_prob`` and ``class_id`` too) joined over the blocks in
        block order, coordinates in the whole image; the other keys are the
        first block's."""
        from ..big import OBJECT_KEYS
        from ..matching import relabel_sequential

        axes, axes_out, shape_out, _, blocks = self._big_cover(img, axes, block_size, min_overlap,
                                                               context, verbose=True)
        if np.isscalar(labels_out) and bool(labels_out) is False:
            labels_out = None
        elif labels_out is None:
            labels_out = np.zeros(shape_out, dtype=labels_out_dtype)
        elif labels_out.shape != shape_out:
            raise ValueError(f"'labels_out' must have shape {shape_out} (axes {axes_out}).")

        polys_all = {}
        label_offset = 1

        kwargs_override = dict(axes=axes, overlap_label=None, return_labels=True,
                               return_predict=False)
        if show_progress:
            kwargs_override["show_tile_progress"] = False
        for k, v in kwargs_override.items():
            if k in kwargs:
                print(f"changing '{k}' from {kwargs[k]} to {v}", flush=True)
            kwargs[k] = v

        for block in blocks:
            labels, polys = self.predict_instances(block.read(img, axes=axes), **kwargs)
            labels = block.crop_context(labels, axes=axes_out)
            labels, polys = block.filter_objects(labels, polys, axes=axes_out)
            labels = relabel_sequential(labels, label_offset)[0]
            if labels_out is not None:
                block.write(labels_out, labels, axes=axes_out)
            for k, v in polys.items():
                polys_all.setdefault(k, []).append(v)
            label_offset += len(polys["prob"])
            del labels

        polys_all = {k: (np.concatenate(v) if k in OBJECT_KEYS else v[0])
                     for k, v in polys_all.items()}
        return labels_out, polys_all

    def _big_cover(self, img, axes, block_size, min_overlap, context=None, verbose=False):
        """The blocks (``big.BlockND.cover``) of a block-wise prediction of
        ``img``: ``block_size``, ``min_overlap`` and ``context`` per axis of
        ``axes`` or one for all (the channel axis whole), made divisible by
        the network stride; ``context`` defaults to the tile overlap.
        Returns (axes, the labels' axes, the labels' shape, the block size
        per axis, the blocks); ``verbose`` prints the effective sizes and a
        context below the tile overlap."""
        from ..big import BlockND, _grid_divisible
        n = img.ndim
        axes = axes_check_and_normalize(axes, length=n)
        grid = self._axes_div_by(axes)
        axes_out = self.config.axes.replace("C", "")
        shape_dict = dict(zip(axes, img.shape))
        shape_out = tuple(shape_dict[a] for a in axes_out)

        if context is None:
            context = self._axes_tile_overlap(axes)
        if np.isscalar(block_size):
            block_size = n * [block_size]
        if np.isscalar(min_overlap):
            min_overlap = n * [min_overlap]
        if np.isscalar(context):
            context = n * [context]
        block_size, min_overlap, context = list(block_size), list(min_overlap), list(context)
        if not n == len(block_size) == len(min_overlap) == len(context):
            raise ValueError(f"block_size, min_overlap and context need {n} values (axes {axes})")

        if "C" in axes:
            i = axes_dict(axes)["C"]
            block_size[i] = img.shape[i]
            min_overlap[i] = context[i] = 0

        block_size = tuple(_grid_divisible(g, v, name="block_size", verbose=False)
                           for v, g in zip(block_size, grid))
        min_overlap = tuple(_grid_divisible(g, v, name="min_overlap", verbose=False)
                            for v, g in zip(min_overlap, grid))
        context = tuple(_grid_divisible(g, v, name="context", verbose=False)
                        for v, g in zip(context, grid))

        if verbose:
            print(f"effective: block_size={block_size}, min_overlap={min_overlap}, "
                  f"context={context}", flush=True)
            for a, c, o in zip(axes, context, self._axes_tile_overlap(axes)):
                if c < o:
                    print(f"{a}: context of {c} is small, recommended to use at least {o}",
                          flush=True)

        blocks = BlockND.cover(img.shape, axes, block_size, min_overlap, context, grid)
        return axes, axes_out, shape_out, block_size, blocks

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

    def _instances_from_prediction(self, img_shape, prob, dist, points, prob_class=None,
                                   prob_thresh=None, nms_thresh=None, scale=None,
                                   return_labels=True, timings=None, render_kw=None,
                                   **nms_kwargs):
        """NMS + rasterization -> (labels, details); reference
        model2d.py:315-349 and model3d.py:315-353. ``points=None``: the
        dense maps (prob (sp...), dist (sp..., R) on ``self.device``), else
        a candidate list. ``prob_class`` (a multiclass model's class map
        (sp..., C), or the candidates' rows (K, C)) follows the survivors:
        by their indices into the candidate list, or at their grid points.
        ``scale``, a dict of the image's axes, scales the survivors back to
        the image (the model's ``_rescale``). ``timings["raster"]`` includes
        the copy back to the host."""
        if prob_thresh is None:
            prob_thresh = self.thresholds.prob
        if nms_thresh is None:
            nms_thresh = self.thresholds.nms
        render_kw = dict(render_kw or {})
        if scale is not None:
            render_kw["rescale"] = self._rescale(scale)
        counters = {}
        with span("stardist.nms", timings, "nms"):
            if points is None:
                nms = self._nms_dense(dist, prob, prob_thresh, nms_thresh, stats=counters,
                                      **nms_kwargs)
            else:
                nms = self._nms_sparse(dist, prob, points, nms_thresh, stats=counters,
                                       **nms_kwargs)
            points, probi, disti = nms[:3]
            if prob_class is not None:
                if len(nms) > 3:                         # sparse: the survivors' indices
                    prob_class = prob_class[nms[3]]
                else:                                    # dense: at the survivors' grid points
                    g = torch.tensor(self.config.grid, device=points.device)
                    prob_class = prob_class[tuple((points // g).t())]
                render_kw["prob_class"] = prob_class
            _sync(self.device)
        with span("stardist.raster", timings, "raster"):
            labels, details = self._render_survivors(img_shape, disti, points, probi,
                                                     return_labels=return_labels, **render_kw)
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

        self.thresholds = opt_threshs
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
                          fetch=True, prob_class=None):
        raise NotImplementedError()

    def export_TF(self, fname=None, single_output=True, upsample_grid=True):
        """Export the model as a zipped TF SavedModel for the CSBDeep/StarDist
        Fiji plugin (reference base.py:1113-1158; ``stardist_tpu``'s
        ``export_TF``): a plain-TF-op replay of the network with its
        weights, optional grid upsampling (sparse transposed-conv prob +
        nearest dist), optional single concatenated output; ``fname``
        defaults to ``logdir/TF_SavedModel.zip``. Needs ``tensorflow``.
        Returns the path of the written zip."""
        from .export_tf import export_tf_saved_model
        return export_tf_saved_model(self, fname=fname, single_output=single_output,
                                     upsample_grid=upsample_grid)
