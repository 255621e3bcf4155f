"""JPEG decode/encode through PIL (``infercam_onnx_tpu/codec.py``'s PIL
half; its native libjpeg shim is not ported yet)."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image, UnidentifiedImageError


def decode_rgb(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 RGB; ValueError on corrupt input."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except (OSError, UnidentifiedImageError, SyntaxError) as e:
        raise ValueError(f"corrupt JPEG: {e}") from e


def encode_rgb(frame: np.ndarray) -> bytes:
    """[H, W, 3] uint8 RGB -> JPEG bytes with the reference's output
    settings: quality 95, 4:2:0 chroma subsampling."""
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=95, subsampling=2)
    return buf.getvalue()
