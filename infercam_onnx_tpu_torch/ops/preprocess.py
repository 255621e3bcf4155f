"""Preprocessing: Triangle resize as two float32 matmuls, u8 rounding and
the MobileNet normalize (``infercam_onnx_tpu/ops/preprocess.py``).

The resize products are plain matmuls in the JAX package too (XLA
einsums, no Pallas kernel), so ``torch.matmul`` carries them here. They
run in full float32 whatever the process's TF32 settings
(`config.full_float32`): TF32 would move resample sums across the u8
rounding boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from infercam_onnx_tpu_torch.config import full_float32

# MobileNet normalization constants.
MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def triangle_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] resample matrix for the Triangle filter
    (image-rs ``FilterType::Triangle``, PIL BILINEAR): source center
    ``(o + 0.5) * ratio``, support scaled by ``max(ratio, 1)`` when
    minifying, out-of-range taps dropped and weights renormalized."""
    ratio = in_size / out_size
    sratio = max(ratio, 1.0)
    support = 1.0 * sratio

    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * ratio
        left = max(int(np.floor(center - support)), 0)
        right = min(int(np.ceil(center + support)), in_size - 1)
        total = 0.0
        for i in range(left, right + 1):
            t = abs((i + 0.5 - center) / sratio)
            w = 1.0 - t if t < 1.0 else 0.0
            if w <= 0.0:
                continue
            m[o, i] += w
            total += w
        if total > 0:
            m[o] /= total
    return m.astype(np.float32)


@full_float32()
def preprocess_images(images: torch.Tensor, r_h: torch.Tensor,
                      r_w: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 frames -> [B, h, w, 3] float32 normalized.

    ``r_h`` [h, H] and ``r_w`` [w, W] come from `triangle_resize_matrix`.
    The resampled values are rounded to the u8 grid half away from zero
    (``floor(x + 0.5)``; ``torch.round`` rounds half to even, which differs
    on exact .5 sums), as the reference does by materializing a u8 image.
    """
    b, h_in, w_in, c = images.shape
    x = images.to(torch.float32)
    # vertical then horizontal pass (image-rs order)
    x = torch.matmul(r_h, x.reshape(b, h_in, w_in * c))  # [B, h, W*3]
    h = x.shape[1]
    x = torch.matmul(r_w, x.reshape(b * h, w_in, c))  # [B*h, w, 3]
    x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0) / 255.0
    mean, std = _normalize_constants(x.device)
    return ((x - mean) / std).reshape(b, h, -1, c)


@functools.lru_cache(maxsize=None)
def _normalize_constants(device: torch.device):
    """MEAN and STD on ``device``, copied there once (a host->device copy
    per call would synchronize the stream)."""
    return (torch.from_numpy(MEAN).to(device),
            torch.from_numpy(STD).to(device))


class Preprocessor:
    """Caches the resize matrices per input size, on the device."""

    def __init__(self, out_width: int, out_height: int,
                 device: torch.device):
        self.out_width = out_width
        self.out_height = out_height
        self.device = device
        self._cache: dict[tuple[int, int],
                          tuple[torch.Tensor, torch.Tensor]] = {}

    def matrices(self, in_width: int,
                 in_height: int) -> tuple[torch.Tensor, torch.Tensor]:
        key = (in_width, in_height)
        if key not in self._cache:
            r_h = triangle_resize_matrix(in_height, self.out_height)
            r_w = triangle_resize_matrix(in_width, self.out_width)
            self._cache[key] = (torch.from_numpy(r_h).to(self.device),
                                torch.from_numpy(r_w).to(self.device))
        return self._cache[key]
