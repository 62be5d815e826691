from .model2d import Config2D, StarDist2D

__all__ = ["Config2D", "StarDist2D"]
