"""Axes handling utilities.

Self-contained replacement for the csbdeep axes helpers that the reference
package relies on (``axes_check_and_normalize``, ``axes_dict``, axis
permutation; see reference usage at stardist/models/base.py:23,385-391).
"""
from __future__ import annotations

import numpy as np

ALLOWED_AXES = "STCZYX"


def axes_check_and_normalize(axes, length=None, disallowed=None, return_allowed=False):
    """Validate an axes string: subset of ``STCZYX``, unique, optional length.

    Mirrors csbdeep.utils.axes_check_and_normalize semantics ('S' may be
    given as 'N').
    """
    if axes is None:
        raise ValueError("axes cannot be None")
    axes = str(axes).upper().replace("N", "S")
    for a in axes:
        if a not in ALLOWED_AXES:
            raise ValueError(f"invalid axis '{a}', must be one of {tuple(ALLOWED_AXES)}")
        if disallowed is not None and a in disallowed:
            raise ValueError(f"disallowed axis '{a}'")
        if axes.count(a) > 1:
            raise ValueError(f"axis '{a}' occurs more than once")
    if length is not None and len(axes) != length:
        raise ValueError(f"axes '{axes}' must be of length {length}")
    return (axes, ALLOWED_AXES) if return_allowed else axes


def axes_dict(axes):
    """Return a dict mapping each allowed axis to its index in ``axes`` (or None)."""
    axes = axes_check_and_normalize(axes)
    return {a: (axes.index(a) if a in axes else None) for a in ALLOWED_AXES}


def move_image_axes(x, fr, to, adjust_singletons=False):
    """Permute array axes from axes-string ``fr`` to ``to``.

    Missing target axes are inserted as singleton dimensions; missing source
    axes must be singletons (dropped), otherwise an error is raised.
    """
    fr = axes_check_and_normalize(fr, length=x.ndim)
    to = axes_check_and_normalize(to)

    fr_initial = fr
    x_shape_initial = x.shape
    if adjust_singletons:
        # drop singleton source axes not present in target
        slices = tuple(slice(None) if (a in to or x.shape[i] != 1) else 0 for i, a in enumerate(fr))
        x = x[slices]
        fr = "".join(a for i, a in enumerate(fr) if (a in to or x_shape_initial[i] != 1))
        # add singleton axes present in target but missing from source
        for a in to:
            if a not in fr:
                x = np.expand_dims(x, -1)
                fr += a

    if set(fr) != set(to):
        extra_src = set(fr) - set(to)
        extra_dst = set(to) - set(fr)
        if extra_src:
            raise ValueError(
                f"image has axes {fr_initial} with shape {x_shape_initial}, "
                f"but cannot be converted to axes {to}: source axes {extra_src} missing in target"
            )
        # insert singleton axes for target-only axes
        for a in extra_dst:
            x = np.expand_dims(x, -1)
            fr += a

    perm = tuple(fr.index(a) for a in to)
    return np.transpose(x, perm)
