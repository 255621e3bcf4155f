"""JPEG decode/encode (``infercam_onnx_tpu/codec.py``).

Every call goes through the port's native libjpeg shim
(``native/jpeg.py``): batch decode on a C++ thread pool, with the GIL
released. Where the JAX codec falls back to PIL when its shim will not
build, this one raises: a silent fallback would hide the decode bound the
shim removes. PIL stays as `_pil_decode` and `_pil_encode`, the oracle of
the tests, which nothing on the serving path calls.
"""

from __future__ import annotations

import io
import logging

import numpy as np
from PIL import Image, UnidentifiedImageError

from infercam_onnx_tpu_torch.native import jpeg as native_jpeg

log = logging.getLogger(__name__)

_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def decode_rgb(data: bytes, scale: int = 1) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 RGB; ValueError on corrupt input.

    ``scale`` in {1, 2, 4, 8} decodes at 1/scale resolution through
    libjpeg's IDCT scaling."""
    return native_jpeg.load().decode_rgb(data, scale)


def decode_batch(datas: list[bytes], scale: int = 1) -> list[np.ndarray]:
    """Decode many JPEGs on the shim's thread pool; ValueError if any of
    them is corrupt."""
    return native_jpeg.load().decode_batch(datas, scale=scale)


def encode_rgb(frame: np.ndarray, quality: int = 95,
               subsampling: str = "420") -> bytes:
    """[H, W, 3] uint8 RGB -> JPEG bytes. The defaults are the reference's
    output settings: quality 95, 4:2:0 chroma subsampling."""
    return native_jpeg.load().encode_rgb(frame, quality, subsampling)


def _pil_decode(data: bytes, scale: int = 1) -> np.ndarray:
    try:
        with Image.open(io.BytesIO(data)) as im:
            if scale > 1:
                im.draft("RGB", (im.width // scale, im.height // scale))
            return np.asarray(im.convert("RGB"))
    except (OSError, UnidentifiedImageError, SyntaxError,
            Image.DecompressionBombError) as e:
        raise ValueError(f"corrupt JPEG: {e}") from e


def _pil_encode(frame: np.ndarray, quality: int = 95,
                subsampling: str = "420") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality,
                                subsampling=_SUBSAMPLING[subsampling])
    return buf.getvalue()
