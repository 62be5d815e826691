from .model2d import Config2D, StarDist2D
from .model3d import Config3D, StarDist3D

__all__ = ["Config2D", "Config3D", "StarDist2D", "StarDist3D"]
