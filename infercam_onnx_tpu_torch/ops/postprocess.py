"""Detection postprocessing: confidence filter + greedy hard-NMS, batched
with fixed output shapes (``infercam_onnx_tpu/ops/postprocess.py``).

Semantics are the reference's (strict ``conf > min_confidence``, strict
``iou > max_iou``, EPS-guarded IoU, zero area for ill-formed boxes,
descending-confidence order with ties to the larger prior index),
reformulated over the best ``top_k`` candidates and padded to
``max_detections``.

``impl`` picks the greedy-suppression form:

- "kernel" (default): `ops.nms.greedy_suppress`, the hand CUDA kernel on
  CUDA tensors and its plain scan version on CPU tensors;
- "xla": the parallel fixpoint closure, the JAX package's default form;
- "scan": the sequential scan.

All give identical keep masks.
"""

from __future__ import annotations

import torch

from infercam_onnx_tpu_torch.ops.nms import (  # noqa: F401 (re-exported)
    EPS,
    bbox_area,
    greedy_suppress,
    greedy_suppress_reference,
    iou_matrix,
)

IMPLS = ("kernel", "xla", "scan")


def _select_candidates(conf: torch.Tensor, boxes: torch.Tensor,
                       min_confidence: float, top_k: int):
    """[B, K] conf, [B, K, 4] boxes -> the ``top_k`` best candidates'
    boxes, confidences and validity, in descending confidence with ties
    going to the larger prior index.

    ``torch.topk`` makes no promise on ties, so this is a stable
    descending sort of the reversed vector: on it a tie keeps the lower
    reversed index first, i.e. the higher original index (the JAX
    package's ``lax.top_k`` over ``conf[::-1]``)."""
    k = conf.shape[-1]
    valid = conf > min_confidence  # strict >, reference nn.rs:127
    _, ridx = torch.sort(conf.flip(-1), dim=-1, descending=True, stable=True)
    order = (k - 1) - ridx[:, :top_k]
    cand_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return (cand_boxes, torch.gather(conf, 1, order),
            torch.gather(valid, 1, order))


def _greedy_keep_closure(cand_boxes: torch.Tensor, cand_valid: torch.Tensor,
                         max_iou: float) -> torch.Tensor:
    """Greedy keep mask as the fixpoint of
    ``x <- valid & !(M^T x > 0)`` from ``x0 = valid`` (M = strictly
    upper-triangular suppression matrix in rank order); it reaches the
    greedy solution exactly in at most top_k steps (see the JAX
    package's ``_greedy_keep_closure`` for the argument). Each step reads
    the mask back to test convergence."""
    top_k = cand_boxes.shape[1]
    rank = torch.arange(top_k, device=cand_boxes.device)
    earlier = rank[:, None] < rank[None, :]
    m = (earlier & (iou_matrix(cand_boxes, cand_boxes) > max_iou)).float()
    valid_f = cand_valid.float()
    x = valid_f
    for _ in range(top_k + 1):
        hit = torch.einsum("bji,bj->bi", m, x)
        y = valid_f * (hit < 0.5).float()
        if torch.equal(y, x):
            break
        x = y
    return x > 0.5


def _compact(cand_boxes, cand_conf, keep, max_detections: int):
    """Move kept candidates to the front, preserving confidence order."""
    comp = torch.argsort((~keep).to(torch.uint8), dim=-1,
                         stable=True)[:, :max_detections]
    kept = torch.gather(keep, 1, comp)
    out_boxes = torch.gather(cand_boxes, 1, comp[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(kept[..., None], out_boxes, 0.0)
    out_conf = torch.where(kept, torch.gather(cand_conf, 1, comp), 0.0)
    count = torch.clamp(keep.sum(dim=-1), max=max_detections)
    return out_boxes, out_conf, count.to(torch.int32)


def batched_nms(conf: torch.Tensor, boxes: torch.Tensor, *,
                min_confidence: float = 0.5, max_iou: float = 0.5,
                top_k: int = 256, max_detections: int = 64,
                impl: str = "kernel"):
    """Filter + greedy NMS over [B, K] confidences and [B, K, 4] boxes.

    Returns ``boxes [B, D, 4]`` (zero-padded), ``conf [B, D]`` and
    ``count [B]`` int32, D = ``min(max_detections, top_k, K)``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    k = conf.shape[1]
    top_k = min(top_k, k)
    max_detections = min(max_detections, top_k)
    cand_boxes, cand_conf, cand_valid = _select_candidates(
        conf, boxes, min_confidence, top_k)
    if impl == "kernel":
        keep = greedy_suppress(
            cand_boxes.transpose(1, 2).contiguous(),  # [B, 4, top_k]
            cand_valid[:, None, :].float(),
            max_iou=max_iou)[:, 0, :] > 0.5
    elif impl == "scan":
        keep = greedy_suppress_reference(
            cand_boxes.transpose(1, 2), cand_valid[:, None, :].float(),
            max_iou=max_iou)[:, 0, :] > 0.5
    else:
        keep = _greedy_keep_closure(cand_boxes, cand_valid, max_iou)
    return _compact(cand_boxes, cand_conf, keep, max_detections)


def batched_postprocess(scores: torch.Tensor, boxes: torch.Tensor, *,
                        min_confidence: float = 0.5, max_iou: float = 0.5,
                        top_k: int = 256, max_detections: int = 64,
                        impl: str = "kernel"):
    """`batched_nms` on the face class of [B, K, 2] softmax scores."""
    return batched_nms(
        scores[..., 1], boxes, min_confidence=min_confidence,
        max_iou=max_iou, top_k=top_k, max_detections=max_detections,
        impl=impl)
