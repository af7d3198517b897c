"""Crop labelled boxes into an image set for representation learning.

The counterpart of ``cli/crop_bboxes.py`` (``data/datasets_repr.
crop_and_save_bboxes``): ``.jpg`` sources need cv2, ``.bmp`` sources are
read and their crops written as ``.bmp`` by the port itself.

Usage:
    python -m ayolov2_torch.cli.crop_bboxes --img-dir data/coco/images/train2017 \\
        --save-dir data/crops
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from ayolov2_torch.data.datasets_repr import crop_and_save_bboxes


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Crop GT boxes to images.")
    parser.add_argument("--img-dir", type=str, required=True)
    parser.add_argument("--save-dir", type=str, required=True)
    parser.add_argument("--min-size", type=int, default=32)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    return crop_and_save_bboxes(args.img_dir, args.save_dir, args.min_size)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    main()
