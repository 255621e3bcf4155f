"""Holding published detections to the reference's.

A published record (the ``/detections`` NDJSON of one frame) is compared
with the reference's answer for the frame it answers: every prior's face
confidence and box before the filter and the suppression (the
candidates), and the reference's own detections after them. The distance
between two detections is ``max(|confidence gap|, largest box-coordinate
gap)``, boxes relative to the frame.

- ``det_gap``: the widest distance of a published detection from the
  nearest reference candidate. Rounding that moves a confidence across
  the threshold, or turns a suppression between two near-equal boxes the
  other way, still finds its candidate close by; an altered confidence or
  box, or a detection the reference has nowhere, does not.
- ``miss_gap``: the widest miss of a reference detection: its distance
  from the nearest published detection, or its confidence's margin over
  ``min_confidence`` where that is smaller (a detection that rounding
  moved below the threshold). A reference detection that a published one
  overlaps by more than ``max_iou`` at a confidence at most
  ``SUPPRESS_TOL`` lower is a suppression turned the other way, and no
  miss. A frame's detections left out read their margins.
- ``unmatched``: records that answer no frame their stream sent (see
  `assign`).
- ``size_gap``: records whose width and height are not the frame's as
  decoded.

Beside them, not held to a limit: ``off_share``, the share (%) of
published detections farther than ``OFF`` from every candidate (a
bfloat16 rounding that went the other way).
"""

from __future__ import annotations

import numpy as np

SUPPRESS_TOL = 0.05
TIE = 1e-9
# distances are read up to FAR: a candidate whose confidence lies FAR
# below the threshold is farther than that from every published detection
FAR = 0.25
OFF = 1e-3


def _dist(a_conf, a_boxes, b_conf, b_boxes) -> np.ndarray:
    """[len(a), len(b)] distances between two sets of detections."""
    return np.maximum(np.abs(a_conf[:, None] - b_conf[None, :]),
                      np.abs(a_boxes[:, None, :] - b_boxes[None, :, :])
                      .max(axis=-1))


def _arrays(dets) -> tuple[np.ndarray, np.ndarray]:
    conf = np.array([c for _, c in dets], np.float64)
    boxes = (np.stack([np.asarray(b, np.float64) for b, _ in dets])
             if dets else np.zeros((0, 4)))
    return conf, boxes


def published(record: dict) -> list:
    return [(d["bbox"], float(d["confidence"])) for d in record["detections"]]


def likeness(pub: list, dets: list) -> float:
    """How far a record's detections lie from a frame's reference
    detections, both ways (the mean of each side's nearest distances; 0
    for two empty lists, 1 where one is empty): the frame a record answers
    is the one it lies nearest."""
    if not pub and not dets:
        return 0.0
    if not pub or not dets:
        return 1.0
    d = _dist(*_arrays(pub), *_arrays(dets))
    return float(d.min(axis=1).mean() + d.min(axis=0).mean())


def _area(x: np.ndarray) -> np.ndarray:
    return np.prod(np.clip(x[..., 2:] - x[..., :2], 0.0, None), axis=-1)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box ``a`` [4] against boxes ``b`` [N, 4]."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0.0, None), axis=-1)
    return inter / (_area(a) + _area(b) - inter + 1e-7)


def record_gaps(pub: list, conf: np.ndarray, boxes: np.ndarray,
                dets: list, cfg: dict) -> tuple[float, float, int]:
    """(det_gap, miss_gap, detections farther than OFF) of one record's
    detections ``pub`` against one frame's reference (``conf`` [K],
    ``boxes`` [K, 4] its candidates, ``dets`` its detections)."""
    p_conf, p_boxes = _arrays(pub)
    near = conf > cfg["min_confidence"] - FAR
    if not len(pub):
        gaps = np.zeros(0)
    elif not near.any():
        gaps = np.full(len(pub), FAR)
    else:
        gaps = np.minimum(FAR, _dist(
            p_conf, p_boxes, conf[near].astype(np.float64),
            boxes[near].astype(np.float64)).min(axis=1))
    det_gap = float(gaps.max(initial=0.0))
    miss_gap = 0.0
    for box, c in dets:
        box = np.asarray(box, np.float64)
        margin = c - cfg["min_confidence"]
        if not len(pub):
            miss_gap = max(miss_gap, margin)
            continue
        nearest = float(_dist(np.array([c]), box[None], p_conf,
                              p_boxes).min())
        suppressed = bool(((_iou(box, p_boxes) > cfg["max_iou"])
                           & (p_conf >= c - SUPPRESS_TOL)).any())
        if not suppressed:
            miss_gap = max(miss_gap, min(nearest, margin))
    return det_gap, miss_gap, int((gaps > OFF).sum())


def assign(records: list, sent_at: list, ref_dets: list) -> list:
    """Pair each record of one stream with the frame it answers.

    ``records``: [(arrival time, record)] in the order they arrived;
    ``sent_at``: each frame's send time; ``ref_dets``: the reference's
    detections of each sensor-noise draw (frame ``j`` shows draw ``j %
    len(ref_dets)``). A stream's answers come in the order its frames
    were sent, each frame answered at most once (the server may shed a
    frame): each record is paired with the earliest frame after the
    previous record's whose draw it lies nearest to (`likeness`) and that
    was sent before the record arrived. Returns the frame index of each
    record, or None where there is no such frame (a stale or misplaced
    answer)."""
    n = len(ref_dets)
    out, prev = [], -1
    for arrived, record in records:
        pub = published(record)
        scores = [likeness(pub, d) for d in ref_dets]
        best = min(scores)
        frame = None
        for v, score in enumerate(scores):
            if score > best + TIE:
                continue
            j = prev + 1 + (v - prev - 1) % n
            if j < len(sent_at) and sent_at[j] <= arrived and (
                    frame is None or j < frame):
                frame = j
        out.append(frame)
        if frame is not None:
            prev = frame
    return out


def compare(judged: list, references: dict, cfg: dict) -> dict:
    """``judged``: [(stream, draw, record, size as decoded)];
    ``references``: {stream: [(conf, boxes, dets) of each draw]}. The
    widest gaps, the records with a wrong size, the number of records and
    of published detections."""
    det_gap = miss_gap = 0.0
    size_gap = detections = off = 0
    for stream, draw, record, size in judged:
        conf, boxes, dets = references[stream][draw]
        pub = published(record)
        d, m, o = record_gaps(pub, conf, boxes, dets, cfg)
        det_gap, miss_gap, off = max(det_gap, d), max(miss_gap, m), off + o
        size_gap += (record["width"], record["height"]) != tuple(size)
        detections += len(pub)
    return {"det_gap": det_gap, "miss_gap": miss_gap,
            "size_gap": float(size_gap), "records": len(judged),
            "detections": detections,
            "off_share": 100.0 * off / max(detections, 1)}
