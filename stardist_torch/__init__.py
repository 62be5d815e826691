"""stardist_torch — StarDist 2D and 3D instance prediction and training in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``stardist_tpu``'s prediction path: ``StarDist2D`` and
``StarDist3D.predict_instances`` (normalize -> U-Net or, in 3D, ResNet
forward -> candidate extraction -> greedy star-polygon / star-polyhedron NMS
-> label rasterization), ``predict_instances_device`` and the block-wise
``predict_instances_big`` (:mod:`.big`); of its training, ``StarDist2D.train``
and ``StarDist3D.train`` (targets built on the model's device, float32
autograd, Adam; weight files the JAX package reads); of the threshold
search; and of multiclass models (``n_classes``) in all of these. The
U-Net's 3x3 and 3x3x3 convolutions, the 2D NMS pair-overlap estimator, the
2D label raster and the 3D NMS's exact lattice count run as CUDA kernels on
CUDA tensors
(``stardist_torch/csrc``) and as their plain PyTorch versions on CPU
tensors.

The parallel layer (:mod:`.parallel`): data-parallel training over the
ranks of a ``torch.distributed`` process group (each rank on its rows of
the batch, the same update as one process), block-wise prediction of big
images with the block forwards spread over devices
(``predict_instances_big_sharded``) or over ranks
(``predict_instances_big_multihost``), and ``dryrun_multichip``. The
weight imports: Keras HDF5 files of upstream StarDist's model zoo
(``load_weights``, with ``h5py``) and the model registry
(``models.register_model``, ``StarDist2D.from_pretrained``). The native
host library (:mod:`.lib`, built with g++) is the test oracle and the C
embedding ABI; no model path calls it.

The interop surface: the prediction CLI (:mod:`.scripts`,
``stardist-torch-predict2d`` / ``-predict3d``), ``export_TF`` (a zipped
TF SavedModel for the Fiji plugin), bioimage.io export and import
(:mod:`.bioimageio_utils`; each package imports the other's zip), the
bundled test images (:mod:`.data`), the plotting helpers (:mod:`.plot`),
profiling (:mod:`.core.profiling`) and the flat namespace of the JAX
package's ``__init__`` below.

This package imports torch, numpy and scipy only; the optional packages
(imageio, matplotlib, yaml, tensorflow, h5py) are imported inside the
functions that need them.
"""
from .version import __version__
from .matching import matching, matching_dataset
from .models import Config2D, Config3D, StarDist2D, StarDist3D
from .nms import (non_maximum_suppression, non_maximum_suppression_3d,
                  non_maximum_suppression_3d_sparse, non_maximum_suppression_sparse)
from .utils import (calculate_extents, edt_prob, export_imagej_rois, fill_label_holes,
                    gputools_available, mask_to_categorical, sample_points)
from .geometry import (dist_to_coord, dist_to_coord3D, export_to_obj_file3D, polygons_to_label,
                       polyhedron_to_label, ray_angles, relabel_image_stardist,
                       relabel_image_stardist3D, star_dist, star_dist3D)
from .rays3d import (Rays_Base, Rays_Cartesian, Rays_Explicit, Rays_GoldenSpiral, Rays_Octo,
                     Rays_SubDivide, Rays_Tetra, rays_from_json, reorder_faces)
from .sample_patches import sample_patches
from .plot.plot import _draw_polygons, draw_polygons, random_label_cmap
from .plot.render import render_label, render_label_pred
from .bioimageio_utils import export_bioimageio, import_bioimageio

__all__ = ["__version__", "matching", "matching_dataset", "Config2D", "Config3D",
           "StarDist2D", "StarDist3D", "non_maximum_suppression",
           "non_maximum_suppression_sparse", "non_maximum_suppression_3d",
           "non_maximum_suppression_3d_sparse", "edt_prob", "fill_label_holes", "sample_points",
           "calculate_extents", "export_imagej_rois", "gputools_available",
           "mask_to_categorical", "star_dist", "polygons_to_label", "relabel_image_stardist",
           "ray_angles", "dist_to_coord", "star_dist3D", "polyhedron_to_label",
           "relabel_image_stardist3D", "dist_to_coord3D", "export_to_obj_file3D", "Rays_Base",
           "Rays_Explicit", "Rays_Cartesian", "Rays_SubDivide", "Rays_Tetra", "Rays_Octo",
           "Rays_GoldenSpiral", "rays_from_json", "reorder_faces", "sample_patches",
           "random_label_cmap", "draw_polygons", "render_label", "render_label_pred",
           "export_bioimageio", "import_bioimageio"]
