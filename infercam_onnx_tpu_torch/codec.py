"""JPEG decode/encode through PIL (``infercam_onnx_tpu/codec.py``'s PIL
half; its native libjpeg shim is not ported yet)."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image, UnidentifiedImageError

_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def decode_rgb(data: bytes, scale: int = 1) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 RGB; ValueError on corrupt input.

    ``scale`` in {1, 2, 4, 8} decodes at 1/scale resolution through
    libjpeg's DCT scaling (PIL's draft mode)."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            if scale > 1:
                im.draft("RGB", (im.width // scale, im.height // scale))
            return np.asarray(im.convert("RGB"))
    except (OSError, UnidentifiedImageError, SyntaxError,
            Image.DecompressionBombError) as e:
        raise ValueError(f"corrupt JPEG: {e}") from e


def decode_batch(datas: list[bytes], scale: int = 1) -> list[np.ndarray]:
    """Decode many JPEGs; ValueError if any of them is corrupt."""
    return [decode_rgb(d, scale) for d in datas]


def encode_rgb(frame: np.ndarray, quality: int = 95,
               subsampling: str = "420") -> bytes:
    """[H, W, 3] uint8 RGB -> JPEG bytes. The defaults are the reference's
    output settings: quality 95, 4:2:0 chroma subsampling."""
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality,
                                subsampling=_SUBSAMPLING[subsampling])
    return buf.getvalue()
