"""Golden detection checks with the >=95% box/confidence fidelity gate.

The port's copy of ``infercam_onnx_tpu/eval/goldens.py``
(`check_against_goldens` and the frame loading it needs) and of
``infercam_onnx_tpu/eval/parity.py``:

- detections are greedily matched by IoU (highest first);
- a match counts toward *box parity* when IoU >= `IOU_THRESH` and
  toward *confidence parity* when also ``|conf_got - conf_want| <=
  CONF_TOL``;
- parity = matched / max(len(want), len(got)), so both misses and extras
  count against it.

A goldens fixture is a JSON file ``{"resize": [w, h] | null,
"detections": {filename: [[x0, y0, x1, y1, conf], ...]}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np

from infercam_onnx_tpu_torch import codec

EPS = 1e-7
IOU_THRESH = 0.5
CONF_TOL = 0.02
MIN_PARITY = 0.95
Detections = Sequence[tuple[np.ndarray, float]]


def _area(b) -> float:
    w = b[2] - b[0]
    h = b[3] - b[1]
    return 0.0 if (w < 0.0 or h < 0.0) else float(w * h)


def iou(a, b) -> float:
    """IoU of two corner boxes with the reference's EPS guard."""
    overlap = [max(a[0], b[0]), max(a[1], b[1]),
               min(a[2], b[2]), min(a[3], b[3])]
    inter = _area(overlap)
    return inter / (_area(a) + _area(b) - inter + EPS)


@dataclasses.dataclass
class ParityReport:
    images: int = 0
    want_total: int = 0
    got_total: int = 0
    box_matched: int = 0
    conf_matched: int = 0

    @property
    def box_parity(self) -> float:
        denom = max(self.want_total, self.got_total)
        return self.box_matched / denom if denom else 1.0

    @property
    def conf_parity(self) -> float:
        denom = max(self.want_total, self.got_total)
        return self.conf_matched / denom if denom else 1.0

    def as_dict(self) -> dict:
        return {
            "images": self.images,
            "want_total": self.want_total,
            "got_total": self.got_total,
            "box_matched": self.box_matched,
            "conf_matched": self.conf_matched,
            "box_parity": round(self.box_parity, 4),
            "conf_parity": round(self.conf_parity, 4),
        }


def match_detections(got: Detections,
                     want: Detections) -> list[tuple[int, int, float]]:
    """Greedy IoU matching: [(got_idx, want_idx, iou)], best IoU first."""
    pairs = []
    for i, (gb, _) in enumerate(got):
        for j, (wb, _) in enumerate(want):
            v = iou(np.asarray(gb, np.float64), np.asarray(wb, np.float64))
            if v >= IOU_THRESH:
                pairs.append((v, i, j))
    pairs.sort(reverse=True)
    used_g: set[int] = set()
    used_w: set[int] = set()
    out = []
    for v, i, j in pairs:
        if i in used_g or j in used_w:
            continue
        used_g.add(i)
        used_w.add(j)
        out.append((i, j, v))
    return out


def parity_report(got_sets: Sequence[Detections],
                  want_sets: Sequence[Detections]) -> ParityReport:
    report = ParityReport()
    for got, want in zip(got_sets, want_sets):
        report.images += 1
        report.want_total += len(want)
        report.got_total += len(got)
        for gi, wi, _ in match_detections(got, want):
            report.box_matched += 1
            if abs(got[gi][1] - want[wi][1]) <= CONF_TOL:
                report.conf_matched += 1
    return report


def fidelity_gate(report: ParityReport) -> bool:
    """True iff both box and confidence parity clear `MIN_PARITY`."""
    return (report.box_parity >= MIN_PARITY
            and report.conf_parity >= MIN_PARITY)


def load_directory_frames(directory: str,
                          resize: tuple[int, int] | None = None
                          ) -> dict[str, np.ndarray]:
    """filename -> decoded [H, W, 3] uint8 frame for every JPEG in dir;
    ``resize=(w, h)`` applies a PIL-bilinear resize after decode."""
    out: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(directory)):
        if not name.lower().endswith((".jpg", ".jpeg")):
            continue
        with open(os.path.join(directory, name), "rb") as f:
            frame = codec.decode_rgb(f.read())
        if resize is not None:
            from PIL import Image

            frame = np.asarray(Image.fromarray(frame).resize(
                resize, Image.BILINEAR))
        out[name] = frame
    return out


def detect_directory(detector, directory: str,
                     resize: tuple[int, int] | None = None
                     ) -> dict[str, list]:
    """filename -> [[x0,y0,x1,y1,conf], ...] for every JPEG in dir."""
    out: dict[str, list] = {}
    for name, frame in load_directory_frames(directory, resize).items():
        out[name] = [[*map(float, bbox), float(conf)]
                     for bbox, conf in detector.detect(frame)]
    return out


def _as_detection_sets(table: dict[str, list], names: list[str]):
    return [[(np.asarray(row[:4], np.float32), row[4])
             for row in table.get(n, [])] for n in names]


def check_against_goldens(detector, directory: str,
                          goldens_path: str) -> dict:
    """Run ``detector`` over the JPEGs in ``directory`` (resized as the
    fixture says) and gate the result against the fixture;
    ``result["passed"]`` is the verdict."""
    with open(goldens_path) as f:
        meta = json.load(f)
    resize = tuple(meta["resize"]) if meta.get("resize") else None
    got_table = detect_directory(detector, directory, resize=resize)
    want_table = meta["detections"]
    names = sorted(set(got_table) | set(want_table))
    report = parity_report(_as_detection_sets(got_table, names),
                           _as_detection_sets(want_table, names))
    result = report.as_dict()
    result["passed"] = fidelity_gate(report)
    result["min_parity"] = MIN_PARITY
    return result
