"""Configuration base class with JSON round-trip.

Self-contained replacement of csbdeep.models.BaseConfig (used by reference
Config2D/Config3D, stardist/models/model2d.py:8,198-262). The serialized
``config.json`` uses the same keys as the reference so that reference model
folders can be loaded.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from .axes import axes_check_and_normalize, axes_dict


class BaseConfig(argparse.Namespace):
    def __init__(self, axes="YX", n_channel_in=1, n_channel_out=1, allow_new_parameters=False, **kwargs):
        axes = axes_check_and_normalize(axes)
        # spatial axes only (drop channel); batch axis not allowed here
        if "S" in axes:
            raise ValueError("sample axis 'S' not allowed in config axes")
        n_dim = len(axes.replace("C", ""))
        if n_dim not in (2, 3):
            raise ValueError(f"expected 2 or 3 spatial axes, got '{axes}'")
        if "C" not in axes:
            axes += "C"
        # channels-last convention (TPU/XLA native layout)
        if axes[-1] != "C":
            axes = axes.replace("C", "") + "C"

        self.n_dim = n_dim
        self.axes = axes
        self.n_channel_in = int(max(1, n_channel_in))
        self.n_channel_out = int(max(1, n_channel_out))
        self.train_checkpoint = "weights_best.h5"
        self.train_checkpoint_last = "weights_last.h5"
        self.train_checkpoint_epoch = "weights_now.h5"

        self.update_parameters(allow_new_parameters, **kwargs)

    def is_valid(self, return_invalid=False):
        return (True, tuple()) if return_invalid else True

    def update_parameters(self, allow_new=False, **kwargs):
        if not allow_new:
            attr_new = [k for k in kwargs if not hasattr(self, k)]
            if attr_new:
                raise AttributeError(f"Not allowed to add new parameters ({', '.join(attr_new)})")
        for k in kwargs:
            setattr(self, k, kwargs[k])

    def to_dict(self):
        return dict(vars(self))

    def save_json(self, path):
        Path(path).write_text(json.dumps(self.to_dict(), **{"indent": None}))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def save_json(data, path, **kwargs):
    with open(path, "w") as f:
        json.dump(data, f, **kwargs)
