"""Command-line 3D prediction (the CLI of stardist_tpu/scripts/predict3d.py;
reference stardist/scripts/predict3d.py)."""
from __future__ import annotations

import sys

from .predict2d import make_parser, run


def main():
    args = make_parser(3).parse_args()
    from ..models import StarDist3D
    run(args, StarDist3D, 3)


if __name__ == "__main__":
    sys.exit(main())
