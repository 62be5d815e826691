from .axes import axes_check_and_normalize, axes_dict, move_image_axes
from .config import BaseConfig, load_json, save_json
from .normalize import normalize, normalize_mi_ma, Normalizer, NoNormalizer, PercentileNormalizer
