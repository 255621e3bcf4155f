"""Greedy hard-NMS suppression: the hand CUDA kernel and its plain version.

`greedy_suppress` is the port of the Pallas TPU kernel
``infercam_onnx_tpu/ops/pallas/nms.py:greedy_suppress`` (the repo's one
``pl.pallas_call``), with the same interface: corner boxes ``[B, 4, K]``
in descending-confidence order and a 0/1 validity mask ``[B, 1, K]`` in,
a float 0/1 keep mask ``[B, 1, K]`` out. On CUDA tensors it launches
``csrc/nms.cu`` (see the note there for its design and what bounds it);
on CPU tensors it runs `greedy_suppress_reference`, the sequential scan
form, which `tests/` and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from infercam_onnx_tpu_torch import kernels

EPS = 1e-7  # IoU denominator guard (reference nn.rs:17-18)
SOURCE = "nms.cu"


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] corner-form boxes; ill-formed boxes -> 0."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.where((w < 0.0) | (h < 0.0), 0.0, w * h)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = bbox_area(torch.cat([tl, br], dim=-1))
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return inter / (union + EPS)


def greedy_suppress_reference(boxes_t: torch.Tensor, valid: torch.Tensor,
                              *, max_iou: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the sequential greedy scan.

    Candidate i is kept iff ``valid[i] > 0.5`` and no kept j < i has
    ``iou(j, i) > max_iou`` (strict)."""
    boxes = boxes_t.transpose(1, 2)  # [B, K, 4]
    suppress = iou_matrix(boxes, boxes) > max_iou  # [B, j, i]
    ok = valid[:, 0, :] > 0.5
    keep = torch.zeros_like(ok)
    for i in range(ok.shape[1]):
        overlapped = (keep & suppress[:, :, i]).any(dim=1)
        keep[:, i] = ok[:, i] & ~overlapped
    return keep.to(torch.float32)[:, None, :]


class NmsKernel:
    """``csrc/nms.cu`` loaded with ctypes, built at first launch.

    ``launches`` counts the kernel launches made through this object."""

    def __init__(self):
        self.launches = 0
        self._lib: ctypes.CDLL | None = None

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = kernels.load(SOURCE)
            lib.nms_greedy_suppress.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            lib.nms_greedy_suppress.restype = ctypes.c_int
            lib.nms_max_k.argtypes = []
            lib.nms_max_k.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, boxes_t: torch.Tensor, valid: torch.Tensor,
                 max_iou: float) -> torch.Tensor:
        b, four, k = boxes_t.shape
        if four != 4 or tuple(valid.shape) != (b, 1, k):
            raise ValueError(
                f"want boxes_t [B, 4, K] and valid [B, 1, K], got "
                f"{tuple(boxes_t.shape)} and {tuple(valid.shape)}")
        for name, t in (("boxes_t", boxes_t), ("valid", valid)):
            if t.device != boxes_t.device or t.device.type != "cuda":
                raise ValueError(f"{name} must be a CUDA tensor on "
                                 f"{boxes_t.device}, got {t.device}")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32")
        lib = self.library()
        if k > lib.nms_max_k():
            raise ValueError(f"K={k} exceeds the kernel's limit of "
                             f"{lib.nms_max_k()} candidates")
        keep = torch.empty((b, 1, k), dtype=torch.float32,
                           device=boxes_t.device)
        if b == 0 or k == 0:
            return keep
        # the tensors' device is current for the launch only
        with torch.cuda.device(boxes_t.device):
            rc = lib.nms_greedy_suppress(
                boxes_t.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
                float(max_iou), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"nms kernel launch failed: CUDA error {rc} "
                f"({lib.cuda_error_string(rc).decode()})")
        self.launches += 1
        return keep


kernel = NmsKernel()


def greedy_suppress(boxes_t: torch.Tensor, valid: torch.Tensor, *,
                    max_iou: float = 0.5) -> torch.Tensor:
    """Keep mask [B, 1, K] float 0/1: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if boxes_t.device.type == "cpu":
        return greedy_suppress_reference(boxes_t, valid, max_iou=max_iou)
    return kernel(boxes_t, valid, max_iou)
