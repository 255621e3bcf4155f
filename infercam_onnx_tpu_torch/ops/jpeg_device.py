"""The device half of the packed-YCbCr decode: chroma upsampling and
BT.601 colour conversion (``infercam_onnx_tpu/ops/jpeg_device.py``'s
`unpack_ycbcr_planes` and `combine_ycbcr`).

The host decodes each JPEG to its Y, Cb and Cr planes (entropy decode and
IDCT, ``native/jpeg.py`` `decode_ycbcr_batch`); one packed uint8 batch
goes to the device. There the chroma planes are upsampled with the
Triangle resize matrices (libjpeg's "fancy" upsampling, edge replication
included) and converted with libjpeg's BT.601 full-range constants. The
JAX package computes these with XLA einsums outside any Pallas kernel, so
the upsample products are ``torch.matmul`` here, in IEEE float32 whatever
the process's TF32 settings (`config.full_float32`); its 0.75/0.25 taps on
integer planes are exact in float32.
"""

from __future__ import annotations

import functools

import torch

from infercam_onnx_tpu_torch.config import full_float32
from infercam_onnx_tpu_torch.ops.preprocess import triangle_resize_matrix


@functools.lru_cache(maxsize=None)
def _upsample_matrix(size: int, device: torch.device) -> torch.Tensor:
    """The [2 * size, size] Triangle upsampling matrix on ``device``,
    copied there once."""
    return torch.from_numpy(triangle_resize_matrix(size, 2 * size)).to(device)


def unpack_ycbcr_planes(packed: torch.Tensor, *, y_pw: int, y_ph: int,
                        c_pw: int, c_ph: int):
    """[B, n] packed uint8 (``decode_ycbcr_batch``'s layout) -> float32
    (y [B, y_ph, y_pw], cb, cr [B, c_ph, c_pw]) planes."""
    b = packed.shape[0]
    ysz, csz = y_pw * y_ph, c_pw * c_ph
    y = packed[:, :ysz].reshape(b, y_ph, y_pw).to(torch.float32)
    cb = packed[:, ysz:ysz + csz].reshape(b, c_ph, c_pw).to(torch.float32)
    cr = packed[:, ysz + csz:ysz + 2 * csz].reshape(
        b, c_ph, c_pw).to(torch.float32)
    return y, cb, cr


@full_float32()
def combine_ycbcr(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, *,
                  width: int, height: int,
                  sampling: tuple[int, int]) -> torch.Tensor:
    """[B, h, w] float planes (0..255, chroma at its subsampled size, all
    iMCU-padded) -> [B, height, width, 3] float32 RGB on the u8 grid.

    ``sampling`` is the luma (h, v) factor pair: (2, 2) 4:2:0, (2, 1)
    4:2:2, (1, 1) 4:4:4. The planes are cropped to ``height`` x ``width``
    (chroma to its share) before the colour pass. The BT.601 products run
    in JAX's order, then ``torch.round`` (half to even, as ``jnp.round``;
    not preprocess's ``floor(x + 0.5)``) and a clamp to 0..255."""
    hs, vs = sampling
    y = y[:, :height, :width]
    if hs == 2 or vs == 2:
        ch = (height + vs - 1) // vs
        cw = (width + hs - 1) // hs
        chroma = [c[:, :ch, :cw] for c in (cb, cr)]
        if vs == 2:  # [2ch, ch] @ [B, ch, cw]
            up_h = _upsample_matrix(ch, y.device)
            chroma = [torch.matmul(up_h, c) for c in chroma]
        if hs == 2:  # [B, h, cw] @ [cw, 2cw]
            up_w = _upsample_matrix(cw, y.device).T
            chroma = [torch.matmul(c, up_w) for c in chroma]
        cb, cr = chroma
    cb = cb[:, :height, :width] - 128.0
    cr = cr[:, :height, :width] - 128.0

    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0.0, 255.0)
