from .geom2d import (dist_to_coord, polygons_to_label, polygons_to_label_coord, ray_angles,
                     relabel_image_stardist, star_dist)
from .geom3d import dist_to_coord3D, polyhedron_to_label

__all__ = ["dist_to_coord", "dist_to_coord3D", "polygons_to_label", "polygons_to_label_coord",
           "polyhedron_to_label", "ray_angles", "relabel_image_stardist", "star_dist"]
