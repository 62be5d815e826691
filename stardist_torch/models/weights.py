"""Reading and writing the reference's checkpoints without flax or msgpack.

``stardist_tpu`` saves its parameters with ``flax.serialization.to_bytes``:
a msgpack map ``{"params": {...}}`` (the file starts with
``\\x81\\xa6params``; a batch-norm net's adds ``"batch_stats"``) whose array
leaves are msgpack ext type 1, each holding a nested msgpack ``(shape,
dtype name, raw buffer)``. :func:`msgpack_loads`
decodes the subset of msgpack that flax emits and :func:`msgpack_dumps`
writes it as msgpack's packer does; :func:`params_from_flax` maps the flax
parameter tree onto :class:`.unet.StarDistNet`'s state dict and
:func:`params_to_flax` / :func:`flax_variables` back.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def sint(self, n):
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        if t >= 0xE0:
            return t - 0x100
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):                     # bin 8/16/32
            return self.take(self.uint(1 << (t - 0xC4)))
        if t in (0xC7, 0xC8, 0xC9):                     # ext 8/16/32
            n = self.uint(1 << (t - 0xC7))
            return self._ext(self.sint(1), self.take(n))
        if t == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= t <= 0xCF:                           # uint 8..64
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:                           # int 8..64
            return self.sint(1 << (t - 0xD0))
        if 0xD4 <= t <= 0xD8:                           # fixext 1..16
            code = self.sint(1)
            return self._ext(code, self.take(1 << (t - 0xD4)))
        if t in (0xD9, 0xDA, 0xDB):                     # str 8/16/32
            return self.take(self.uint(1 << (t - 0xD9))).decode()
        if t in (0xDC, 0xDD):                           # array 16/32
            return [self.obj() for _ in range(self.uint(2 if t == 0xDC else 4))]
        if t in (0xDE, 0xDF):                           # map 16/32
            return self._map(self.uint(2 if t == 0xDE else 4))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, code, payload):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = msgpack_loads(payload)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_loads(data):
    """Decode one msgpack object (the subset flax writes)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _header(out, n, fix, fix_max, codes):
    """A length header: the fix form below ``fix_max``, else the first of
    the 8/16/32-bit ``codes`` (None where msgpack has no such form) that holds n."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, size in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * size):
            out.append(code)
            out += n.to_bytes(size, "big")
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(obj, out):
    if isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode()
        _header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, bytes):
        _header(out, len(obj), 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool) and obj >= 0:
        obj = int(obj)
        if obj < 128:
            out.append(obj)
        else:
            size = next(s for s in (1, 2, 4, 8) if obj < 1 << (8 * s))
            out.append({1: 0xCC, 2: 0xCD, 4: 0xCE, 8: 0xCF}[size])
            out += obj.to_bytes(size, "big")
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        payload = msgpack_dumps((arr.shape, arr.dtype.name, arr.tobytes()))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _header(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
        out.append(_EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"no msgpack encoding for {type(obj).__name__} here")


def msgpack_dumps(obj):
    """Encode nested dicts, lists, strings, bytes, non-negative ints and
    numpy arrays (as flax's ndarray ext type) as msgpack."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def load_flax_variables(path):
    """The variable tree of a flax msgpack checkpoint: ``{"params": ...}``,
    with ``"batch_stats"`` for a batch-norm net (nested dicts of numpy
    arrays)."""
    with open(path, "rb") as f:
        raw = f.read()
    tree = msgpack_loads(raw)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a flax checkpoint with a 'params' entry")
    return tree


def load_flax_checkpoint(path):
    """The parameter tree of a flax msgpack checkpoint (nested dicts of
    numpy arrays)."""
    return load_flax_variables(path)["params"]


def params_from_flax(net, params, batch_stats=None):
    """State dict of ``net`` (:class:`.unet.StarDistNet`) from a flax
    parameter tree (numpy or array-like leaves) and, for a batch-norm net,
    its ``batch_stats`` tree.

    Module names follow the flax call order. U-Net: top-level
    ``ConvBlock_i`` are the grid pre-pooling convs then the feature conv;
    ``UNetBackbone_0/ConvBlock_j`` the backbone, each with ``BatchNorm_0``
    where the net has batch norm. ResNet: ``Conv_0`` (7^3) and ``Conv_1``
    (3^3), ``ResNetBlock_b/Conv_k`` (the shortcut last) each followed by
    ``ResNetBlock_b/BatchNorm_k`` with batch norm, ``ConvBlock_0`` the
    feature conv. Then ``head_prob`` / ``head_dist``, the 1x1 heads; a
    multiclass net's class branch is the next top-level ``ConvBlock`` (its
    feature conv, made after the heads) and ``head_prob_class``. Conv
    kernels stay HWIO (k, k, C, Cout) / DHWIO. A batch norm's ``scale`` and
    ``bias`` are under ``params``, its ``mean`` and ``var`` under
    ``batch_stats``."""
    def arr(p):
        return torch.from_numpy(np.array(p, np.float32))

    def leaf(tree, path):
        for key in path.split("/"):
            tree = tree[key]
        return tree

    if net.batch_norm and batch_stats is None:
        raise ValueError("the net has batch norm: its batch_stats are needed")
    sd = {}
    for name, path, bn_path in _conv_names(net):
        p = leaf(params, path)
        sd[f"{name}.weight"], sd[f"{name}.bias"] = arr(p["kernel"]), arr(p["bias"])
        if bn_path is not None:
            p, st = leaf(params, bn_path), leaf(batch_stats, bn_path)
            sd[f"{name}.bn.scale"], sd[f"{name}.bn.bias"] = arr(p["scale"]), arr(p["bias"])
            sd[f"{name}.bn.mean"], sd[f"{name}.bn.var"] = arr(st["mean"]), arr(st["var"])
    for head in _head_names(net):
        k = np.array(params[head]["kernel"], np.float32)
        sd[f"{head}.weight"] = torch.from_numpy(k.reshape(k.shape[-2:]).copy())
        sd[f"{head}.bias"] = torch.from_numpy(np.array(params[head]["bias"], np.float32))
    return sd


def _head_names(net):
    return ("head_prob", "head_dist") + (("head_prob_class",) if net.n_classes is not None
                                         else ())


def _conv_names(net):
    """(state-dict prefix, flax path of the conv, flax path of its batch norm
    or None) of each conv of ``net``, in flax's order of creation; the class
    branch's feature conv last (flax makes it after the heads)."""
    if net.backbone_kind == "resnet":
        out = [("stem.0", "Conv_0", None), ("stem.1", "Conv_1", None)]
        for b, blk in enumerate(net.blocks):
            out += [(f"blocks.{b}.convs.{k}", f"ResNetBlock_{b}/Conv_{k}",
                     f"ResNetBlock_{b}/BatchNorm_{k}" if conv.bn is not None else None)
                    for k, conv in enumerate(blk.convs)]
            if blk.shortcut is not None:
                out.append((f"blocks.{b}.shortcut", f"ResNetBlock_{b}/Conv_{len(blk.convs)}",
                            None))
        if net.feat is not None:
            out.append(("feat", "ConvBlock_0/Conv_0", None))
        n_top = 1
    else:
        n_pre = len(net.prepools) * net.n_conv
        out = [(f"top.{i}", f"ConvBlock_{i}/Conv_0", None) for i in range(n_pre)]
        out += [(f"backbone.{j}", f"UNetBackbone_0/ConvBlock_{j}/Conv_0",
                 f"UNetBackbone_0/ConvBlock_{j}/BatchNorm_0" if blk.bn is not None else None)
                for j, blk in enumerate(net.backbone)]
        out += [(f"top.{i}", f"ConvBlock_{i}/Conv_0", None) for i in range(n_pre, len(net.top))]
        n_top = len(net.top)
    if net.feat_class is not None:
        out.append(("feat_class", f"ConvBlock_{n_top}/Conv_0", None))
    return out


def flax_variables(net):
    """The flax variable tree of ``net`` (numpy float32 leaves):
    ``{"params": ...}``, with ``"batch_stats"`` for a batch-norm net, in
    the order flax creates the modules (U-Net: the grid pre-pooling convs,
    the backbone, the feature conv; ResNet: the stem, the blocks, the
    feature conv; a batch norm after its conv; then the prob and dist
    heads, and a multiclass net's class feature conv and class head); the
    inverse of :func:`params_from_flax`, and the reference's layout of its
    checkpoint files."""
    sd = net.state_dict()

    def arr(name):
        return sd[name].detach().cpu().float().numpy().copy()

    def node(tree, path):
        for key in path.split("/"):
            tree = tree.setdefault(key, {})
        return tree

    def head(name):
        w = arr(f"{name}.weight")
        return {"kernel": w.reshape((1,) * net.n_dim + w.shape), "bias": arr(f"{name}.bias")}

    params, stats = {}, {}
    convs = _conv_names(net)
    class_conv = convs.pop() if net.feat_class is not None else None
    for name, path, bn_path in convs:
        node(params, path).update(kernel=arr(f"{name}.weight"), bias=arr(f"{name}.bias"))
        if bn_path is not None:
            node(params, bn_path).update(scale=arr(f"{name}.bn.scale"), bias=arr(f"{name}.bn.bias"))
            node(stats, bn_path).update(mean=arr(f"{name}.bn.mean"), var=arr(f"{name}.bn.var"))
    params["head_prob"], params["head_dist"] = head("head_prob"), head("head_dist")
    if net.n_classes is not None:
        if class_conv is not None:
            name, path, _ = class_conv
            node(params, path).update(kernel=arr(f"{name}.weight"), bias=arr(f"{name}.bias"))
        params["head_prob_class"] = head("head_prob_class")
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def params_to_flax(net):
    """The flax parameter tree of ``net`` (:func:`flax_variables`'s
    ``"params"``)."""
    return flax_variables(net)["params"]


def save_flax_checkpoint(path, net):
    """Write ``net``'s variables as the reference's checkpoint file."""
    with open(path, "wb") as f:
        f.write(msgpack_dumps(flax_variables(net)))
