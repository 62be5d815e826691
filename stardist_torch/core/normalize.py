"""Input normalization (self-contained csbdeep.data.Normalizer replacement).

The reference model layer accepts a ``normalizer`` object with ``before``/
``after`` hooks (csbdeep PercentileNormalizer, used via
``StarDistBase._check_normalizer_resizer``; see reference
stardist/models/base.py:399-402). We reproduce that contract.
"""
from __future__ import annotations

import numpy as np

from .axes import axes_check_and_normalize, axes_dict


def normalize(x, pmin=3, pmax=99.8, axis=None, clip=False, eps=1e-20, dtype=np.float32):
    """Percentile-based image normalization (csbdeep.utils.normalize semantics)."""
    mi = np.percentile(x, pmin, axis=axis, keepdims=True)
    ma = np.percentile(x, pmax, axis=axis, keepdims=True)
    return normalize_mi_ma(x, mi, ma, clip=clip, eps=eps, dtype=dtype)


def normalize_mi_ma(x, mi, ma, clip=False, eps=1e-20, dtype=np.float32):
    if dtype is not None:
        x = x.astype(dtype, copy=False)
        mi = dtype(mi) if np.isscalar(mi) else mi.astype(dtype, copy=False)
        ma = dtype(ma) if np.isscalar(ma) else ma.astype(dtype, copy=False)
        eps = dtype(eps)
    x = (x - mi) / (ma - mi + eps)
    if clip:
        x = np.clip(x, 0, 1)
    return x


class Normalizer:
    """Base class: subclasses implement before/after."""

    def before(self, x, axes):
        raise NotImplementedError()

    def after(self, mean, scale, axes):
        raise NotImplementedError()

    @property
    def do_after(self):
        return False


class NoNormalizer(Normalizer):
    def __init__(self, do_after=False):
        self._do_after = do_after

    def before(self, x, axes):
        return x

    def after(self, mean, scale, axes):
        if self.do_after:
            raise ValueError("NoNormalizer has no effect")
        return mean, scale

    @property
    def do_after(self):
        return self._do_after


class PercentileNormalizer(Normalizer):
    """Percentile normalization applied per channel."""

    def __init__(self, pmin=2, pmax=99.8, do_after=False, dtype=np.float32, **kwargs):
        if not (np.isscalar(pmin) and np.isscalar(pmax) and 0 <= pmin < pmax <= 100):
            raise ValueError("percentiles must satisfy 0 <= pmin < pmax <= 100")
        self.pmin = pmin
        self.pmax = pmax
        self._do_after = do_after
        self.dtype = dtype
        self.kwargs = kwargs

    def before(self, x, axes):
        axes = axes_check_and_normalize(axes, x.ndim)
        axis = tuple(d for d, a in enumerate(axes) if a != "C")
        self.mi = np.percentile(x, self.pmin, axis=axis, keepdims=True).astype(self.dtype, copy=False)
        self.ma = np.percentile(x, self.pmax, axis=axis, keepdims=True).astype(self.dtype, copy=False)
        return normalize_mi_ma(x, self.mi, self.ma, dtype=self.dtype, **self.kwargs)

    def after(self, mean, scale, axes):
        if not self.do_after:
            raise ValueError("do_after is False")
        alpha = self.ma - self.mi
        beta = self.mi
        return (
            (alpha * mean + beta).astype(self.dtype, copy=False),
            (alpha * scale).astype(self.dtype, copy=False) if scale is not None else None,
        )

    @property
    def do_after(self):
        return self._do_after
