"""stardist_torch — StarDist 2D and 3D instance prediction, and 2D training,
in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``stardist_tpu``'s prediction path: ``StarDist2D`` and
``StarDist3D.predict_instances`` (normalize -> U-Net forward -> candidate
extraction -> greedy star-polygon / star-polyhedron NMS -> label
rasterization); and of its 2D training, ``StarDist2D.train`` (targets built
on the model's device, float32 autograd, Adam; weight files the JAX package
reads). The 3x3 and 3x3x3 convolutions and the 2D NMS pair-overlap
estimator run as CUDA kernels on CUDA tensors (``stardist_torch/csrc``) and
as their plain PyTorch versions on CPU tensors.

This package imports torch, numpy and scipy only.
"""
from .version import __version__
from .matching import matching, matching_dataset
from .models import Config2D, Config3D, StarDist2D, StarDist3D

__all__ = ["__version__", "matching", "matching_dataset", "Config2D", "Config3D",
           "StarDist2D", "StarDist3D"]
