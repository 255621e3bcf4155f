"""Detector configuration, device selection and float32 precision.

``DetectorConfig`` mirrors ``infercam_onnx_tpu/config.py:DetectorConfig``
with the same defaults (the reference's serve-time setup: RFB-320,
max_iou 0.5, min_confidence 0.5).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detection model + post-processing configuration."""

    variant: str = "RFB-320"  # RFB-320/640 or slim-320/640
    max_iou: float = 0.5
    min_confidence: float = 0.5
    # `top_k` candidates enter NMS; `max_detections` boxes come out.
    top_k: int = 256
    max_detections: int = 64
    # dtype of the conv trunk; float32 is used by parity tests.
    compute_dtype: str = "bfloat16"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises rather than falling back.

    A CUDA device with no GPU present is an error: the port never carries
    on silently on the CPU. Pass ``device="cpu"`` to run there on purpose.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls and cuDNN convs in IEEE float32 within the block.

    PyTorch lets cuDNN convs use TF32 by default, and any caller may turn
    it on for matmuls; TF32 moves the resize sums across the u8 rounding
    boundary and the float32 trunk off its reference. This sets both
    per-op precisions to ``"ieee"`` and restores the caller's after. It
    uses only the ``fp32_precision`` settings, which are what the CUDA
    kernels read. They are process-wide: float32 work on other threads
    during the block runs in IEEE float32 too."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
