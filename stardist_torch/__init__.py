"""stardist_torch — StarDist 2D instance prediction in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

The port of ``stardist_tpu``'s main path: ``StarDist2D.predict_instances``
(normalize -> U-Net forward -> candidate extraction -> greedy star-polygon
NMS -> label rasterization). The 3x3 convolution and the NMS pair-overlap
estimator run as CUDA kernels on CUDA tensors (``stardist_torch/csrc``) and
as their plain PyTorch versions on CPU tensors.

This package imports torch, numpy and scipy only.
"""
from .version import __version__
from .matching import matching, matching_dataset
from .models import Config2D, StarDist2D

__all__ = ["__version__", "matching", "matching_dataset", "Config2D",
           "StarDist2D"]
