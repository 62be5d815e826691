"""The plain reference of StarDist instance prediction, and the comparison
that judges the program's output with it.

It reads the model folder (config.json, thresholds.json, weights_best.h5)
and nothing of the program: the forward of ``unet.py`` or, for a model
with ``backbone: "resnet"``, of ``resnet.py``, the candidates
above the prob threshold away from a border of 2 grid cells, the greedy
NMS of ``greedy.py`` with the overlaps of ``star2d.py`` / ``star3d.py``,
and the label image.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import labels, star2d, star3d
from .greedy import greedy
from .resnet import PlainResNet
from .unet import PlainStarDist, fp8_round
from .weights import load_flax_variables

BORDER = 2      # predict_instances' default border, in grid cells


class Reference:
    def __init__(self, model_dir, device, precision="float32"):
        model_dir = Path(model_dir)
        cfg = json.loads((model_dir / "config.json").read_text())
        thr = json.loads((model_dir / "thresholds.json").read_text())
        params = load_flax_variables(model_dir / "weights_best.h5")["params"]
        net = PlainResNet if cfg.get("backbone") == "resnet" else PlainStarDist
        self.net = net(cfg, params, device, precision)
        self.nd = int(cfg["n_dim"])
        self.grid = tuple(int(g) for g in cfg["grid"])
        self.prob_thresh, self.nms_thresh = float(thr["prob"]), float(thr["nms"])
        self.device = torch.device(device)
        if self.nd == 3:
            rays = cfg["rays_json"]
            if rays["name"] != "Rays_GoldenSpiral":
                raise ValueError(f"the reference draws golden-spiral rays, not {rays}")
            self.dirs, self.faces = star3d.golden_spiral(int(rays["kwargs"]["n"]),
                                                         rays["kwargs"].get("anisotropy"))

    def maps(self, img):
        """prob (*sp'), dist (R, *sp') float32 on the device."""
        return self.net(img)

    def candidates(self, prob, dist):
        """(prob (K,), dist (K, R) >= 1e-3, points (K, nd) in pixels), by
        descending prob."""
        mask = prob > self.prob_thresh
        for ax in range(self.nd):
            idx = [slice(None)] * self.nd
            idx[ax] = slice(0, BORDER)
            mask[tuple(idx)] = False
            idx[ax] = slice(prob.shape[ax] - BORDER, None)
            mask[tuple(idx)] = False
        at = torch.nonzero(mask)                                     # (K, nd) grid cells
        p = prob[tuple(at.t())]
        order = torch.sort(p, descending=True, stable=True).indices
        at, p = at[order], p[order]
        d = dist[(slice(None),) + tuple(at.t())].t().clamp_min(1e-3)
        return p, d, at * torch.tensor(self.grid, device=at.device)

    def shapes(self, dist, points):
        if self.nd == 2:
            return star2d.Polygons(dist, points, self.nms_thresh)
        return star3d.Polyhedra(dist, points, self.dirs, self.faces, self.nms_thresh)

    def raster(self, dist, points, prob, shape, rnd=None):
        if self.nd == 2:
            return star2d.raster(dist, points, prob, shape, rnd=rnd)
        return star3d.raster(dist, points, prob, shape, self.dirs, self.faces, rnd=rnd)

    def instances(self, img, maps=None):
        """The reference's whole prediction: dict of ``labels`` and the
        survivors' ``dist``, ``points``, ``prob``, tensors on the device.
        In fp8 (the control) the label image is drawn with the distances
        and each pixel's offset from the centre rounded to fp8 too."""
        prob, dist = self.maps(img) if maps is None else maps
        p, d, pts = self.candidates(prob, dist)
        keep = greedy(self.shapes(d, pts))
        p, d, pts = p[keep], d[keep], pts[keep]
        rnd = fp8_round if self.net.precision == "fp8" else None
        return dict(labels=self.raster(d, pts, p, np.shape(img)[:self.nd], rnd),
                    dist=d, points=pts, prob=p)

    def judge(self, img, out, maps=None, ref=None):
        """The numbers compared for one output ``out`` of the program (dict
        of ``labels``, ``dist``, ``points``, ``prob``: numpy or tensors)
        on the image ``img``: the widest gaps of its survivors' prob and
        dist to the reference's maps at their grid cells, the pixels where
        its labels differ from the reference's drawing of its own
        survivors, and how far its objects and the reference's whole
        prediction's fall short of matching each other (``iou_deficit``)."""
        if maps is None:
            maps = self.maps(img)
        if ref is None:
            ref = self.instances(img, maps)
        dev = self.device
        t = {k: torch.as_tensor(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v))
             .to(dev) for k, v in out.items() if k in ("labels", "dist", "points", "prob")}
        prob, dist = maps
        cell = tuple((t["points"].long() // torch.tensor(self.grid, device=dev)).t())
        n = len(t["prob"])
        prob_gap = float((t["prob"].double() - prob[cell].double()).abs().max()) if n else 0.0
        dist_ref = dist[(slice(None),) + cell].t().clamp_min(1e-3)
        dist_gap = float((t["dist"].double() - dist_ref.double()).abs().max()) if n else 0.0
        drawn = self.raster(t["dist"].float(), t["points"], t["prob"].float(),
                            tuple(t["labels"].shape))
        return dict(prob_gap=prob_gap, dist_gap=dist_gap,
                    label_diff_px=labels.differing_pixels(t["labels"], drawn),
                    iou_deficit=labels.iou_deficit(t["labels"].long(), ref["labels"]))
