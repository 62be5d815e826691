from .plot import random_label_cmap, draw_polygons, _draw_polygons
from .render import render_label, render_label_pred
