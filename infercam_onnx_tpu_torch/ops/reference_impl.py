"""Pure-NumPy oracle of the reference's host-side postprocessing (the
port's copy of ``infercam_onnx_tpu/ops/reference_impl.py``).

A direct, dynamic-shape port of the behavioural contract of reference
infer_server/src/nn.rs:109-260: filter strictly above the threshold,
stable ascending sort, greedy NMS popping from the back, IoU with an EPS
guard and zero area for ill-formed boxes. The tests and ``chip_smoke.py``
hold the fixed-shape device programs (``ops/postprocess.py`` and the NMS
kernel) to it, and the parity metrics (``eval/parity.py``) use its IoU.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-7


def bbox_area(b) -> float:
    w = b[2] - b[0]
    h = b[3] - b[1]
    if w < 0.0 or h < 0.0:
        return 0.0
    return float(w * h)


def iou(a, b) -> float:
    overlap = [max(a[0], b[0]), max(a[1], b[1]),
               min(a[2], b[2]), min(a[3], b[3])]
    inter = bbox_area(overlap)
    return inter / (bbox_area(a) + bbox_area(b) - inter + EPS)


def non_maximum_suppression(
    sorted_candidates: list[tuple[np.ndarray, float]],
    max_iou: float,
) -> list[tuple[np.ndarray, float]]:
    """Greedy NMS over an ascending-confidence-sorted candidate list,
    popping the most confident from the back (reference nn.rs:198-224)."""
    stack = list(sorted_candidates)
    selected: list[tuple[np.ndarray, float]] = []
    while stack:
        bbox, confidence = stack.pop()
        if any(iou(bbox, sel) > max_iou for sel, _ in selected):
            continue
        selected.append((bbox, confidence))
    return selected


def postprocess(
    scores: np.ndarray,  # [K, 2]
    boxes: np.ndarray,  # [K, 4]
    min_confidence: float = 0.5,
    max_iou: float = 0.5,
) -> list[tuple[np.ndarray, float]]:
    """Full reference postprocessing of one image (nn.rs:109-140):
    [(bbox[4], confidence)] in descending confidence order."""
    conf = scores[:, 1]
    cands = [(boxes[i], float(conf[i])) for i in range(len(conf))
             if conf[i] > min_confidence]
    # Python's sort is stable, like Rust's sort_by (nn.rs:132-134)
    cands.sort(key=lambda t: t[1])
    return non_maximum_suppression(cands, max_iou)
