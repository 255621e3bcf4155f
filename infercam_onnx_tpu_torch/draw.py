"""Bounding-box annotation (``infercam_onnx_tpu/draw.py``): hollow green
rectangles from relative coords scaled by the frame dims, with a
"{:.2f}%" confidence label in 16 px DejaVu Sans Mono at the top-left
corner.

The font is the package's own copy, ``resources/DejaVuSansMono.ttf``
(its licence beside it), then matplotlib's copy, then PIL's default
bitmap font.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

GREEN = (0, 255, 0)
FONT_SIZE = 16
_FONT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "resources", "DejaVuSansMono.ttf")


@functools.lru_cache(maxsize=1)
def _font() -> ImageFont.ImageFont:
    try:
        return ImageFont.truetype(_FONT_PATH, FONT_SIZE)
    except OSError:
        pass
    try:
        import matplotlib

        path = os.path.join(os.path.dirname(matplotlib.__file__),
                            "mpl-data", "fonts", "ttf", "DejaVuSansMono.ttf")
        return ImageFont.truetype(path, FONT_SIZE)
    except (ImportError, OSError):
        return ImageFont.load_default()


def draw_detections(
    frame: np.ndarray,
    detections: Sequence[tuple[np.ndarray, float]],
    dims: tuple[int, int] | None = None,
) -> np.ndarray:
    """Draw boxes + confidence labels; returns a new [H, W, 3] uint8 array.

    ``dims``: the (width, height) that scales the relative coords; None
    uses the frame's own size (the reference hard-codes 1280x720)."""
    img = Image.fromarray(frame)
    d = ImageDraw.Draw(img)
    width, height = dims if dims is not None else (img.width, img.height)
    font = _font()
    for bbox, confidence in detections:
        x_tl = int(bbox[0] * width)
        y_tl = int(bbox[1] * height)
        x_br = int(bbox[2] * width)
        y_br = int(bbox[3] * height)
        d.rectangle([x_tl, y_tl, x_br - 1, y_br - 1], outline=GREEN)
        d.text((x_tl, y_tl), f"{confidence * 100.0:.2f}%", fill=GREEN,
               font=font)
    return np.asarray(img)
