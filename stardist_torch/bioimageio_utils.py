"""bioimage.io model export/import (the port's copy of
stardist_tpu/bioimageio_utils.py; reference stardist/bioimageio_utils.py).

The reference builds a full bioimage.io resource (SavedModel bundle + RDF
metadata + deepimagej macro) via the ``bioimageio.core`` library. This
offline build writes the same *contract* without that dependency: a zip
containing ``rdf.yaml`` (format 0.4-style metadata with the stardist
``config:`` section holding the model config + thresholds), the weights as
the flax msgpack checkpoint that both this package and ``stardist_tpu``
read (``models.weights.save_flax_checkpoint``), sample input/output arrays
and, where tensorflow is installed, the TF SavedModel bundle.
``import_bioimageio`` reconstructs a usable model folder from such a zip
(also from one written by ``stardist_tpu``, and reads the stardist
``config:`` section of RDFs produced by the reference exporter).
"""
from __future__ import annotations

import importlib.util
import json
import shutil
import tempfile
import warnings
import zipfile
from pathlib import Path

import numpy as np

# Fiji/deepImageJ postprocessing macro (2D): the deep-learning plugin produces
# a stack whose first channel is the object probability map and whose
# remaining channels are the star-distance rays; this macro hands those to the
# StarDist Fiji plugin's NMS command with the model's calibrated thresholds
# baked in. Functional equivalent of the reference's bundled macro
# (stardist/bioimageio_utils.py:10-53), written for this exporter.
DEEPIMAGEJ_MACRO = """\
// StarDist 2D postprocessing for deepImageJ (requires the StarDist and
// deepImageJ Fiji plugins). Input: the raw network output as a stack whose
// channel 1 is the probability map and channels 2..n_rays+1 are the radial
// distances. Exported by stardist_tpu with calibrated thresholds.
getDimensions(w, h, nch, nsl, nfr);
stack = getTitle();
prob_thresh = {prob};
nms_thresh = {nms};
// channel 1 -> probability scores
run("Make Substack...", "channels=1");
rename("scores");
// channels 2..end -> radial distances
selectWindow(stack);
run("Delete Slice", "delete=channel");
selectWindow(stack);
nrays = maxOf(nch, nsl) - 1;
run("Properties...", "channels=" + nrays + " slices=1 frames=1 pixel_width=1.0 pixel_height=1.0 voxel_depth=1.0");
rename("distances");
// StarDist plugin candidate NMS + label/ROI rendering
run("Command From Macro",
    "command=[de.csbdresden.stardist.StarDist2DNMS], args=['prob':'scores'," +
    " 'dist':'distances', 'probThresh':'" + prob_thresh + "'," +
    " 'nmsThresh':'" + nms_thresh + "', 'outputType':'Both'," +
    " 'excludeBoundary':'2', 'roiPosition':'Stack', 'verbose':'false']," +
    " process=[false]");
"""


def _axes_string(model):
    return "b" + model.config.axes.replace("C", "").lower() + "c"


def export_bioimageio(model, outpath, test_input=None, name=None, mode="tpu_flax",
                      min_percentile=1.0, max_percentile=99.8, overwrite_spec_kwargs=None):
    """Export a trained model as a bioimage.io-style zip package."""
    import yaml

    outpath = Path(outpath)
    if outpath.suffix == "":
        outdir = outpath
        zip_path = outdir / f"{outdir.name}.zip"
    elif outpath.suffix == ".zip":
        outdir = outpath.parent
        zip_path = outpath
    else:
        raise ValueError("outpath has to be a folder or zip file")
    outdir.mkdir(exist_ok=True, parents=True)

    name = model.name if name is None else name
    ndim = model.config.n_dim

    if test_input is None:
        div_by = model._axes_div_by(model.config.axes.replace("C", ""))
        shape = tuple(4 * d for d in div_by)
        rng = np.random.RandomState(0)
        test_input = rng.uniform(0, 1, shape + (model.config.n_channel_in,)).astype(np.float32)
        if model.config.n_channel_in == 1:
            test_input = test_input[..., 0]

    # run the model to produce sample outputs
    prob, dist = model.predict(test_input)[:2]

    # bioimageio tensor specs (reference bioimageio_utils.py:212-259): the
    # input must state its minimum shape / growth step / halo so consumers
    # can tile correctly. Shapes are in b + spatial + c convention.
    axes_net = model.config.axes.replace("C", "")
    div_by = tuple(int(d) for d in model._axes_div_by(axes_net))
    halo = [int(np.ceil(v / 8) * 8) for v in model._axes_tile_overlap(axes_net)]
    min_shape = [ms + 2 * ha for ms, ha in zip((4 * d for d in div_by), halo)]
    min_shape = [ms + (-ms % d) for ms, d in zip(min_shape, div_by)]
    input_min_shape = [1] + min_shape + [model.config.n_channel_in]
    input_step = [0] + list(div_by) + [0]
    halo_bc = [0] + halo + [0]
    in_axes = _axes_string(model)
    preprocessing = [dict(name="scale_range",
                          kwargs=dict(mode="per_sample",
                                      axes=axes_net.lower(),
                                      min_percentile=min_percentile,
                                      max_percentile=max_percentile))]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "test_input.npy", np.asarray(test_input))
        np.save(tmp / "test_prob.npy", prob)
        np.save(tmp / "test_dist.npy", dist)

        weights_name = "stardist_weights.h5"
        from .models.weights import save_flax_checkpoint
        save_flax_checkpoint(tmp / weights_name, model.net)

        weights = {"tpu_flax" if mode == "tpu_flax" else mode:
                   dict(source=weights_name)}

        # TF SavedModel bundle: the weights format real consumers (Fiji,
        # deepImageJ) load. Single concatenated [prob, dist] output at input
        # resolution, like the reference's Fiji export.
        attachments = []
        if importlib.util.find_spec("tensorflow") is not None:
            tf_zip = model.export_TF(fname=tmp / "TF_SavedModel.zip")
            import tensorflow as _tf
            weights["tensorflow_saved_model_bundle"] = dict(
                source=Path(tf_zip).name, tensorflow_version=_tf.__version__)
        else:
            warnings.warn("TF SavedModel bundle not included: tensorflow is not installed")

        config = dict(
            stardist=dict(
                python_version="0.1.0",
                weights_format="flax_msgpack",
                config=model.config.to_dict(),
                thresholds=dict(model.thresholds._asdict()),
            )
        )

        if ndim == 2:
            macro_name = "stardist_postprocessing.ijm"
            (tmp / macro_name).write_text(
                DEEPIMAGEJ_MACRO.format(prob=model.thresholds.prob,
                                        nms=model.thresholds.nms))
            config["stardist"]["postprocessing_macro"] = macro_name
            attachments.append(macro_name)

        rdf = dict(
            format_version="0.4.9",
            type="model",
            name=name,
            description=f"StarDist {ndim}D model ({name}), PyTorch port",
            authors=[dict(name="stardist_torch")],
            license="BSD-3-Clause",
            documentation="README.md",
            cite=[dict(text="Cell Detection with Star-convex Polygons",
                       doi="10.1007/978-3-030-00934-2_30")],
            tags=[f"stardist{ndim}d", "segmentation", "pytorch", "cuda"],
            inputs=[dict(name="input", axes=in_axes,
                         data_type="float32",
                         data_range=["-inf", "inf"],
                         shape=dict(min=input_min_shape, step=input_step),
                         preprocessing=preprocessing)],
            outputs=[
                dict(name="prob", axes=in_axes, data_type="float32",
                     data_range=["-inf", "inf"],
                     halo=halo_bc,
                     shape=dict(reference_tensor="input",
                                scale=[1] + [1 / g for g in model.config.grid] + [0],
                                offset=[0] * (ndim + 1) + [0.5])),
                dict(name="dist", axes=in_axes, data_type="float32",
                     data_range=["-inf", "inf"],
                     halo=halo_bc,
                     shape=dict(reference_tensor="input",
                                scale=[1] + [1 / g for g in model.config.grid] + [0],
                                offset=[0] * (ndim + 1) + [model.config.n_rays / 2])),
            ],
            weights=weights,
            attachments=dict(files=attachments) if attachments else {},
            test_inputs=["test_input.npy"],
            test_outputs=["test_prob.npy", "test_dist.npy"],
            config=config,
        )
        if overwrite_spec_kwargs:
            rdf.update(overwrite_spec_kwargs)
        with open(tmp / "rdf.yaml", "w") as f:
            yaml.safe_dump(rdf, f, sort_keys=False)
        (tmp / "README.md").write_text(
            f"# {name}\n\nStarDist model exported by stardist_torch.\n")

        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
            for p in sorted(tmp.iterdir()):
                z.write(p, p.name)
    return zip_path


def import_bioimageio(source, outpath, *, device="cuda"):
    """Import a bioimage.io stardist package -> model folder at ``outpath``;
    returns the loaded model, on ``device`` (the card by default)."""
    import yaml

    source = Path(source)
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if source.is_dir():
            shutil.copytree(source, tmp / "pkg")
            pkg = tmp / "pkg"
        else:
            with zipfile.ZipFile(source) as z:
                z.extractall(tmp / "pkg")
            pkg = tmp / "pkg"
        rdf_path = next(pkg.rglob("rdf.yaml"))
        with open(rdf_path) as f:
            rdf = yaml.safe_load(f)
        try:
            sd = rdf["config"]["stardist"]
        except (KeyError, TypeError):
            raise ValueError("RDF has no 'config: stardist:' section — not a StarDist package")

        cfg_dict = sd["config"]
        thresholds = sd.get("thresholds", dict(prob=0.5, nms=0.4))

        with open(outpath / "config.json", "w") as f:
            json.dump(cfg_dict, f)
        with open(outpath / "thresholds.json", "w") as f:
            json.dump(thresholds, f)

        # locate weights file
        weights = None
        for w in rdf.get("weights", {}).values():
            cand = rdf_path.parent / w.get("source", "")
            if cand.exists():
                weights = cand
                break
        if weights is None:
            for pat in ("*.h5", "*.msgpack", "*.weights"):
                found = sorted(rdf_path.parent.glob(pat))
                if found:
                    weights = found[0]
                    break
        if weights is not None:
            shutil.copy(weights, outpath / "weights_best.h5")

    from .models import StarDist2D, StarDist3D
    cls = StarDist2D if cfg_dict.get("n_dim", 2) == 2 else StarDist3D
    return cls(None, name=outpath.name, basedir=str(outpath.parent), device=device)
