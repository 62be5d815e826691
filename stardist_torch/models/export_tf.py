"""TensorFlow SavedModel export (the port's copy of
stardist_tpu/models/export_tf.py; reference stardist/models/base.py:1113-1158).

The reference exports its Keras graph as a zipped SavedModel for the
CSBDeep/StarDist Fiji plugin, with `single_output` (concat [prob, dist]) and
`upsample_grid` (prob via stride-`grid` transposed conv with a ones kernel —
i.e. *sparse* upsampling — and dist via nearest-neighbor upsampling).

The port's network is PyTorch, so this module *replays* the exact
`StarDistNet` topology with plain TensorFlow ops, loading the flax-named
variable tree that ``models.weights.flax_variables`` builds from the net.
Plain TF ops (conv/pool/concat) keep the SavedModel loadable by stock TF
runtimes (Fiji's TF-Java, deepimagej).

The replay mirrors flax's deterministic auto-naming (per-parent, per-class
counters) to index the parameter tree; tests/test_torch_export.py holds
its SavedModel to the JAX package's and to the port's forward. Batch norm
replays as the reference's does, from the net's ``batch_stats``, and so
fails where the reference's replay fails: it gives the grid pre-pooling and
feature convs a batch norm that neither net has, and raises
``KeyError('BatchNorm_0')`` for a batch-norm net with either
(tests/test_torch_netconfigs.py).
"""
from __future__ import annotations

import shutil
import tempfile
import warnings
import zipfile
from pathlib import Path

import numpy as np


def _tf():
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("export_TF requires tensorflow to be installed") from e
    return tf


class _Namer:
    """Mirrors flax's auto-naming: per-parent counter per module class."""

    def __init__(self):
        self.counts = {}

    def __call__(self, cls_name):
        i = self.counts.get(cls_name, 0)
        self.counts[cls_name] = i + 1
        return f"{cls_name}_{i}"


def _act(tf, name):
    name = str(name).lower() if not callable(name) else name
    if callable(name):
        raise ValueError("callable activations cannot be exported to TF")
    return {
        "relu": tf.nn.relu,
        "elu": tf.nn.elu,
        "tanh": tf.tanh,
        "sigmoid": tf.sigmoid,
        "linear": lambda x: x,
        "swish": tf.nn.silu,
        "gelu": tf.nn.gelu,
    }[name]


def _conv(tf, x, p, strides=None):
    """flax nn.Conv equivalent: SAME padding, channels-last."""
    nd = p["kernel"].ndim - 2
    y = tf.nn.convolution(x, tf.constant(p["kernel"]), strides=strides,
                          padding="SAME")
    if "bias" in p:
        y = y + tf.constant(p["bias"].reshape((1,) * (nd + 1) + (-1,)))
    return y


def _batch_norm(tf, x, p, stats, eps=1e-5):
    inv = 1.0 / np.sqrt(stats["var"] + eps)
    scale = p.get("scale", np.ones_like(stats["var"])) * inv
    bias = p.get("bias", 0.0) - stats["mean"] * scale
    return x * tf.constant(scale.astype(np.float32)) + tf.constant(bias.astype(np.float32))


def _max_pool(tf, x, pool):
    return tf.nn.max_pool(x, ksize=list(pool), strides=list(pool), padding="VALID")


def _upsample_nearest(tf, x, factors):
    for axis, f in enumerate(factors, start=1):
        if f > 1:
            x = tf.repeat(x, f, axis=axis)
    return x


def _conv_block(tf, x, params, stats, activation, batch_norm):
    namer = _Namer()
    x = _conv(tf, x, params[namer("Conv")])
    if batch_norm:
        name = namer("BatchNorm")
        x = _batch_norm(tf, x, params.get(name, {}), stats[name])
    return _act(tf, activation)(x)


def _unet_backbone(tf, x, params, stats, net):
    """Replays the reference's UNetBackbone.__call__ (stardist_tpu/models/unet.py:104-127)."""
    namer = _Namer()
    bn = net.unet_batch_norm
    act, last_act = net.unet_activation, net.unet_last_activation
    base, depth, n_conv = net.unet_n_filter_base, net.unet_n_depth, net.unet_n_conv_per_depth
    pool = tuple(net.unet_pool)

    def block(x, activation):
        name = namer("ConvBlock")
        return _conv_block(tf, x, params[name], stats.get(name, {}), activation, bn)

    skips = []
    for n in range(depth):
        for _ in range(n_conv):
            x = block(x, act)
        skips.append(x)
        x = _max_pool(tf, x, pool)

    for _ in range(n_conv - 1):
        x = block(x, act)
    x = block(x, act)

    for n in reversed(range(depth)):
        x = tf.concat([_upsample_nearest(tf, x, pool), skips[n]], axis=-1)
        for _ in range(n_conv - 1):
            x = block(x, act)
        x = block(x, act if n > 0 else last_act)
    return x


def _resnet_block(tf, x, params, stats, pool, n_conv, activation, batch_norm,
                  filters):
    namer = _Namer()
    act = _act(tf, activation)

    def maybe_bn(y):
        if batch_norm:
            name = namer("BatchNorm")
            return _batch_norm(tf, y, params.get(name, {}), stats[name])
        return y

    y = _conv(tf, x, params[namer("Conv")], strides=list(pool))
    y = act(maybe_bn(y))
    for i in range(n_conv - 1):
        y = _conv(tf, y, params[namer("Conv")])
        y = maybe_bn(y)
        if i < n_conv - 2:
            y = act(y)
    if any(p > 1 for p in pool) or x.shape[-1] != filters:
        x = _conv(tf, x, params[namer("Conv")], strides=list(pool))
    return act(x + y)


def build_tf_forward(net, params, batch_stats=None):
    """Return a python function x -> (prob, dist[, prob_class]) of TF tensors
    replaying the reference's StarDistNet.__call__
    (stardist_tpu/models/unet.py:200-281) with flax-named float32 numpy
    params and, for a batch-norm net, its ``batch_stats`` tree; ``net`` is
    the model's config (it carries the network's fields)."""
    tf = _tf()
    stats = batch_stats or {}
    nd = net.n_dim
    grid = tuple(net.grid)
    # the backbone's flag on every top-level block, as the reference's replay
    # has it (stardist_tpu/models/export_tf.py:177-180)
    bn = net.unet_batch_norm if net.backbone == "unet" else net.resnet_batch_norm

    def forward(x):
        namer = _Namer()
        p = params
        s = stats

        def conv_block(x, activation):
            name = namer("ConvBlock")
            return _conv_block(tf, x, p[name], s.get(name, {}), activation, bn)

        if net.backbone == "unet":
            pooled = np.ones(nd, int)
            while tuple(pooled) != grid:
                pool = 1 + (np.asarray(grid) > pooled)
                pooled *= pool
                for _ in range(net.unet_n_conv_per_depth):
                    x = conv_block(x, net.unet_activation)
                x = _max_pool(tf, x, tuple(int(q) for q in pool))
            name = namer("UNetBackbone")
            base = _unet_backbone(tf, x, p[name], s.get(name, {}), net)
            n_feat = net.net_conv_after_unet
            feat_act = net.unet_activation
        elif net.backbone == "resnet":
            x = _conv(tf, x, p[namer("Conv")])
            x = _conv(tf, x, p[namer("Conv")])
            n_filter = net.resnet_n_filter_base
            pooled = np.ones(nd, int)
            for _ in range(net.resnet_n_blocks):
                pool = 1 + (np.asarray(grid) > pooled)
                pooled *= pool
                if any(q > 1 for q in pool):
                    n_filter *= 2
                name = namer("ResNetBlock")
                x = _resnet_block(tf, x, p[name], s.get(name, {}),
                                  tuple(int(q) for q in pool),
                                  net.resnet_n_conv_per_block,
                                  net.resnet_activation, net.resnet_batch_norm,
                                  n_filter)
            base = x
            n_feat = net.net_conv_after_resnet
            feat_act = net.resnet_activation
        else:  # pragma: no cover
            raise NotImplementedError(net.backbone)

        feat = conv_block(base, feat_act) if n_feat > 0 else base
        prob = tf.sigmoid(_conv(tf, feat, p["head_prob"]))
        dist = _conv(tf, feat, p["head_dist"])
        if net.n_classes is not None:
            feat_c = conv_block(base, feat_act) if n_feat > 0 else base
            pc = tf.nn.softmax(_conv(tf, feat_c, p["head_prob_class"]), axis=-1)
            return prob, dist, pc
        return prob, dist

    return forward


def _sparse_upsample(tf, prob, grid, nd):
    """Transposed conv with a ones 1x..x1 kernel, stride=grid: the prob value
    lands on one pixel per grid cell, zeros elsewhere (reference
    base.py:1146-1150 — sparse on purpose to limit Fiji candidate counts)."""
    kernel = tf.ones((1,) * nd + (1, 1), tf.float32)
    x_shape = tf.shape(prob)
    spatial = [x_shape[i + 1] * g for i, g in enumerate(grid)]
    out_shape = tf.stack([x_shape[0]] + spatial + [1])
    op = tf.nn.conv2d_transpose if nd == 2 else tf.nn.conv3d_transpose
    return op(prob, kernel, out_shape, strides=[1] + list(grid) + [1],
              padding="SAME")


def export_tf_saved_model(model, fname=None, single_output=True,
                          upsample_grid=True):
    """Export ``model`` to a zipped TF SavedModel (Fiji plugin contract).

    Mirrors reference ``StarDistBase.export_TF`` semantics: multiclass output
    is dropped with a warning; `upsample_grid` emits full-resolution outputs
    (sparse prob, nearest dist); `single_output` concatenates [prob, dist]
    along channels. Returns the path of the written zip.
    """
    tf = _tf()
    if model.basedir is None and fname is None:
        raise ValueError("Need explicit 'fname', since model directory not "
                         "available (basedir=None).")
    if model._is_multiclass():
        warnings.warn("multi-class mode not supported yet, removing "
                      "classification output from exported model")

    from .weights import flax_variables

    nd = model.config.n_dim
    grid = tuple(model.config.grid)
    n_in = model.config.n_channel_in
    variables = flax_variables(model.net)
    forward = build_tf_forward(model.config, variables["params"], variables.get("batch_stats"))

    spec = tf.TensorSpec([None] + [None] * nd + [n_in], tf.float32, name="input")

    class _Module(tf.Module):
        @tf.function(input_signature=[spec])
        def __call__(self, x):
            outs = forward(x)
            prob, dist = outs[0], outs[1]
            if upsample_grid and any(g > 1 for g in grid):
                prob = _sparse_upsample(tf, prob, grid, nd)
                dist = _upsample_nearest(tf, dist, grid)
            if single_output:
                return tf.concat([prob, dist], axis=-1)
            return prob, dist

    module = _Module()
    fname = Path(model.logdir / "TF_SavedModel.zip") if fname is None else Path(fname)
    tmpdir = tempfile.mkdtemp(prefix="stardist_torch_tf_export_")
    try:
        tf.saved_model.save(module, tmpdir)
        fname.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(fname, "w", zipfile.ZIP_DEFLATED) as z:
            for f in sorted(Path(tmpdir).rglob("*")):
                if f.is_file():
                    z.write(f, f.relative_to(tmpdir))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return fname
