"""Label rendering to RGBA overlays (a copy of stardist_tpu/plot/render.py;
reference stardist/plot/render.py)."""
from __future__ import annotations

import numpy as np

from ..matching import matching, _check_label_array


def _single_color_integer_cmap(color=(0.3, 0.4, 0.5)):
    import matplotlib

    assert len(color) in (3, 4)

    class BinaryCmap(matplotlib.colors.Colormap):
        def __init__(self):
            super().__init__("binary")

        def __call__(self, X, alpha=None, bytes=False):
            res = np.zeros(X.shape + (4,), np.float32)
            res[..., -1] = 1
            res[X > 0] = np.asarray(color + ((1.0,) if len(color) == 3 else ()))
            if bytes:
                return np.clip(256 * res, 0, 255).astype(np.uint8)
            return res

    return BinaryCmap()


def _find_boundaries(lbl):
    """Pixels adjacent to a differently-labeled pixel (outer+inner boundary)."""
    b = np.zeros(lbl.shape, bool)
    for ax in range(lbl.ndim):
        sl_a = [slice(None)] * lbl.ndim
        sl_b = [slice(None)] * lbl.ndim
        sl_a[ax] = slice(1, None)
        sl_b[ax] = slice(None, -1)
        diff = lbl[tuple(sl_a)] != lbl[tuple(sl_b)]
        b[tuple(sl_a)] |= diff
        b[tuple(sl_b)] |= diff
    return b


def render_label(lbl, img=None, cmap=None, cmap_img="gray", alpha=0.5,
                 alpha_boundary=None, normalize_img=True):
    """Render a label image as RGBA, optionally overlaid on ``img`` with a
    distinct boundary alpha."""
    from matplotlib import cm

    alpha = np.clip(alpha, 0, 1)
    alpha_boundary = alpha if alpha_boundary is None else np.clip(alpha_boundary, 0, 1)

    if cmap is None:
        from .plot import random_label_cmap
        cmap = random_label_cmap(int(lbl.max()) + 1)
    elif isinstance(cmap, tuple):
        cmap = _single_color_integer_cmap(cmap)

    cmap_img = cm.get_cmap(cmap_img) if isinstance(cmap_img, str) else cmap_img

    if img is None:
        im_img = np.zeros(lbl.shape + (4,), np.float32)
        im_img[..., -1] = 1
    else:
        assert img.ndim in (2, 3) and img.shape[:2] == lbl.shape[:2]
        img = img[..., 0] if (img.ndim == 3 and img.shape[-1] == 1) else img
        if img.ndim == 2:
            x = img.astype(np.float32)
            if normalize_img:
                lo, hi = np.percentile(x, (1, 99.8))
                x = np.clip((x - lo) / (hi - lo + 1e-10), 0, 1)
            im_img = cmap_img(x)
        else:
            im_img = np.concatenate(
                [img[..., :3], np.ones(lbl.shape + (1,), img.dtype)], axis=-1
            ).astype(np.float32)

    im_lbl = cmap(lbl / (lbl.max() + 1e-10)) if lbl.max() > 0 else cmap(lbl.astype(float))
    mask_lbl = lbl > 0
    mask_bound = mask_lbl & _find_boundaries(lbl)

    im = im_img.copy()
    im[mask_lbl] = alpha * im_lbl[mask_lbl] + (1 - alpha) * im_img[mask_lbl]
    im[mask_bound] = alpha_boundary * im_lbl[mask_bound] + (1 - alpha_boundary) * im_img[mask_bound]
    return im


def render_label_pred(y_true, y_pred, img=None, cmap_img="gray", alpha=0.5,
                      alpha_boundary=None, matching_kwargs=None,
                      color_tp=(0.2, 0.8, 0.2), color_fp=(0.8, 0.2, 0.2),
                      color_fn=(0.9, 0.6, 0.1), normalize_img=True):
    """Render a prediction colored by true/false positive/negative status
    against the ground truth (via matching)."""
    _check_label_array(y_true, "y_true")
    _check_label_array(y_pred, "y_pred")
    if matching_kwargs is None:
        matching_kwargs = dict(thresh=0.5)
    res = matching(y_true, y_pred, report_matches=True, **matching_kwargs)

    matched_pred = set(p for i, (t, p) in enumerate(res.matched_pairs) if i in res.matched_tps)
    matched_true = set(t for i, (t, p) in enumerate(res.matched_pairs) if i in res.matched_tps)

    alpha = np.clip(alpha, 0, 1)
    alpha_boundary = alpha if alpha_boundary is None else np.clip(alpha_boundary, 0, 1)

    if img is None:
        im_img = np.zeros(y_pred.shape + (4,), np.float32)
        im_img[..., -1] = 1
    else:
        from matplotlib import cm
        x = np.asarray(img, np.float32)
        x = x[..., 0] if (x.ndim == 3 and x.shape[-1] == 1) else x
        if normalize_img and x.ndim == 2:
            lo, hi = np.percentile(x, (1, 99.8))
            x = np.clip((x - lo) / (hi - lo + 1e-10), 0, 1)
        cmap_img = cm.get_cmap(cmap_img) if isinstance(cmap_img, str) else cmap_img
        im_img = cmap_img(x) if x.ndim == 2 else np.concatenate(
            [x[..., :3], np.ones(x.shape[:2] + (1,), np.float32)], axis=-1)

    im = im_img.copy()

    def _blend(mask, color, a):
        col = np.asarray(color + (1.0,))
        im[mask] = a * col + (1 - a) * im[mask]

    # false negatives: GT objects without match
    fn_mask = np.isin(y_true, [l for l in np.unique(y_true) if l > 0 and l not in matched_true])
    _blend(fn_mask, tuple(color_fn), alpha * 0.5)
    # predictions: tp vs fp
    tp_mask = np.isin(y_pred, sorted(matched_pred))
    fp_mask = (y_pred > 0) & ~tp_mask
    _blend(tp_mask, tuple(color_tp), alpha)
    _blend(fp_mask, tuple(color_fp), alpha)
    bound = (y_pred > 0) & _find_boundaries(y_pred)
    _blend(bound & tp_mask, tuple(color_tp), alpha_boundary)
    _blend(bound & fp_mask, tuple(color_fp), alpha_boundary)
    return im
