"""Command-line 2D prediction: tiff in -> normalize -> predict_instances ->
tiff out (the CLI of stardist_tpu/scripts/predict2d.py; reference
stardist/scripts/predict2d.py). The model runs on the card, the
constructor's default.

    stardist-torch-predict2d -i img.tif -o out/ -m 2D_demo --modeldir models/examples
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _imread(path, ndim=2):
    """A 2D image, or with ``ndim=3`` every page of a tiff stack (the
    reference's ``imread`` reads only a stack's first page)."""
    import imageio.v2 as imageio
    return np.asarray(imageio.volread(path) if ndim == 3 else imageio.imread(path))


def _imwrite(path, arr):
    """A 2D image, or a 3D label volume as a tiff stack (the reference's
    ``imwrite`` refuses a volume)."""
    import imageio.v2 as imageio
    (imageio.volwrite if arr.ndim == 3 else imageio.imwrite)(path, arr)


def make_parser(ndim):
    p = argparse.ArgumentParser(
        description=f"StarDist {ndim}D prediction (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-i", "--input", required=True, help="input image file (tiff)")
    p.add_argument("-o", "--outdir", default=".", help="output directory")
    p.add_argument("-m", "--model", required=True,
                   help="model name (folder in --modeldir) or registered pretrained name")
    p.add_argument("--modeldir", default=".", help="base directory of model folders")
    p.add_argument("--axes", default=None, help="axes of the input image")
    p.add_argument("--n_tiles", type=int, nargs=ndim, default=None, help="number of tiles")
    p.add_argument("--pnorm", type=float, nargs=2, default=[1, 99.8],
                   help="percentiles for input normalization")
    p.add_argument("--prob_thresh", type=float, default=None)
    p.add_argument("--nms_thresh", type=float, default=None)
    p.add_argument("--name", default=None, help="output file name (default: derived from input)")
    p.add_argument("--verbose", action="store_true")
    return p


def run(args, model_cls, ndim):
    """Predict ``args.input`` with ``model_cls(None, name=args.model,
    basedir=args.modeldir)`` and write the labels (uint16 below 2^16
    labels, else int32) to ``args.outdir``; returns (labels, details). An
    in-process caller may set ``args.nms_kwargs``, a dict that goes to
    ``predict_instances`` as its ``nms_kwargs`` (the NMS's ``samples``, for
    one; the parser, as the reference's, has no such option)."""
    from ..core.normalize import normalize

    img = _imread(args.input, ndim)
    x = normalize(img, *args.pnorm)
    model = model_cls(None, name=args.model, basedir=args.modeldir)
    n_tiles = tuple(args.n_tiles) if args.n_tiles is not None else None
    labels, polys = model.predict_instances(
        x, axes=args.axes, n_tiles=n_tiles,
        prob_thresh=args.prob_thresh, nms_thresh=args.nms_thresh,
        verbose=args.verbose, nms_kwargs=getattr(args, "nms_kwargs", None))
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    name = args.name or (Path(args.input).stem + ".labels.tif")
    out_path = outdir / name
    _imwrite(str(out_path), labels.astype(np.uint16 if labels.max() < 2 ** 16 else np.int32))
    print(f"wrote {out_path} ({len(polys['prob'])} objects)")
    return labels, polys


def main():
    args = make_parser(2).parse_args()
    from ..models import StarDist2D
    run(args, StarDist2D, 2)


if __name__ == "__main__":
    sys.exit(main())
