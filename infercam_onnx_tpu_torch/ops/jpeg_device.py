"""The device halves of the JPEG decode (``infercam_onnx_tpu/ops/
jpeg_device.py``).

Packed YCbCr (`unpack_ycbcr_planes`, `combine_ycbcr`): the host decodes
each JPEG to its Y, Cb and Cr planes (entropy decode and IDCT,
``native/jpeg.py`` `decode_ycbcr_batch`); one packed uint8 batch goes to
the device. There the chroma planes are upsampled with the Triangle resize
matrices (libjpeg's "fancy" upsampling, edge replication included) and
converted with libjpeg's BT.601 full-range constants.

Coefficients (`read_coefficient_batch`, `decode_plane`,
`decode_rgb_device`): the host only entropy-decodes; the device
dequantizes and runs the 8x8 IDCT as ``P = A C A^T`` with the orthonormal
DCT-III basis A, batched over every block, then the same chroma and colour
pass.

The JAX package computes all of this with XLA einsums outside any Pallas
kernel, so the products are ``torch.matmul`` here, in IEEE float32
whatever the process's TF32 settings (`config.full_float32`). The
upsample's 0.75/0.25 taps on integer planes are exact in float32; the IDCT
runs in float64 (`dct_basis`) and lands within 1e-3 of XLA's float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from infercam_onnx_tpu_torch.config import full_float32
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops.preprocess import triangle_resize_matrix


def idct_basis() -> np.ndarray:
    """A [8, 8] with pixels = A @ coefs @ A^T (orthonormal DCT-III)."""
    a = np.zeros((8, 8), np.float64)
    for x in range(8):
        for u in range(8):
            cu = np.sqrt(0.5) if u == 0 else 1.0
            a[x, u] = 0.5 * cu * np.cos((2 * x + 1) * u * np.pi / 16)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_basis(device: torch.device) -> torch.Tensor:
    """`idct_basis` (its float32 values) as float64 on ``device``, copied
    there once. The 8x8 transforms run in float64: a sample or coefficient
    sitting on a .5 rounding tie (integer samples make them common: a DC
    coefficient is a sum of 64 of them over 8) then rounds the same way on
    every device and in every summation order."""
    return torch.from_numpy(idct_basis().astype(np.float64)).to(device)


@functools.lru_cache(maxsize=None)
def _upsample_matrix(size: int, device: torch.device) -> torch.Tensor:
    """The [2 * size, size] Triangle upsampling matrix on ``device``,
    copied there once."""
    return torch.from_numpy(triangle_resize_matrix(size, 2 * size)).to(device)


@full_float32()
def decode_plane(coefs: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """[B, bh, bw, 64] int16 blocks + [B, 64] quant -> [B, bh*8, bw*8]
    float32 samples (level-shifted back to 0..255, unclamped)."""
    b, bh, bw, _ = coefs.shape
    c = (coefs.to(torch.float64)
         * quant.to(torch.float64)[:, None, None, :]).reshape(b, bh, bw, 8, 8)
    a = dct_basis(coefs.device)
    # P = A C A^T, computed as P^T = (C A^T)^T A^T: each product folds the
    # blocks into one [N*8, 8] @ [8, 8] matmul
    pt = torch.matmul(torch.matmul(c, a.T).transpose(-1, -2), a.T)
    # pt is [B, bh, bw, y, x]; the plane is [B, bh, x, bw, y]
    return (pt.permute(0, 1, 4, 2, 3).reshape(b, bh * 8, bw * 8)
            + 128.0).to(torch.float32)


def decode_rgb_device(y_coefs: torch.Tensor, cb_coefs: torch.Tensor,
                      cr_coefs: torch.Tensor, quant: torch.Tensor, *,
                      width: int, height: int,
                      sampling: tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Coefficient blocks ([B, bh, bw, 64] int16 each) and their quant
    tables [B, 3, 64] -> [B, height, width, 3] float32 RGB on the u8 grid,
    as a host decode would give it."""
    y = decode_plane(y_coefs, quant[:, 0])
    cb = decode_plane(cb_coefs, quant[:, 1])
    cr = decode_plane(cr_coefs, quant[:, 2])
    return combine_ycbcr(y, cb, cr, width=width, height=height,
                         sampling=sampling)


def read_coefficient_batch(datas: list[bytes]):
    """The host half of the coefficients mode: entropy-decode a batch of
    JPEGs of one geometry (a ctypes call a frame).

    Returns ``(y [B, ...], cb [B, ...], cr [B, ...], quant [B, 3, 64],
    (width, height), (h_samp, v_samp))``; the sampling goes on to the
    device decode, so chroma is upsampled as the stream was subsampled.
    ValueError on an empty batch, a corrupt or unsupported JPEG, or mixed
    geometries or samplings."""
    if not datas:
        raise ValueError("empty JPEG batch")
    native = native_jpeg.load()
    ys, cbs, crs, quants = [], [], [], []
    geom = None
    for data in datas:
        y, cb, cr, quant, (w, h), (hs, vs) = native.read_coefficients(data)
        if geom is None:
            geom = (w, h, y.shape, cb.shape, hs, vs)
        elif geom != (w, h, y.shape, cb.shape, hs, vs):
            raise ValueError("mixed JPEG geometries in batch")
        ys.append(y)
        cbs.append(cb)
        crs.append(cr)
        quants.append(quant)
    return (np.stack(ys), np.stack(cbs), np.stack(crs), np.stack(quants),
            (geom[0], geom[1]), (geom[4], geom[5]))


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
