from .geom2d import dist_to_coord, polygons_to_label, ray_angles

__all__ = ["dist_to_coord", "polygons_to_label", "ray_angles"]
