"""Detection parity metrics, the >=95% fidelity gate (the port's copy of
``infercam_onnx_tpu/eval/parity.py``).

The gate extends the reference's exact-count oracle (reference
infer_server/tests/integration_tests.rs:20-34) to per-box IoU and
confidence parity over any two detection sets:

- detections are greedily matched by IoU (highest first);
- a match counts toward *box parity* when IoU >= ``iou_thresh`` and
  toward *confidence parity* when also ``|conf_got - conf_want| <=
  conf_tol``;
- parity = matched / max(len(want), len(got)), so both misses and extras
  count against it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from infercam_onnx_tpu_torch.ops.reference_impl import iou

Detections = Sequence[tuple[np.ndarray, float]]


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


def match_detections(got: Detections, want: Detections,
                     iou_thresh: float = 0.5
                     ) -> list[tuple[int, int, float]]:
    """Greedy IoU matching: [(got_idx, want_idx, iou)], best IoU first."""
    pairs = []
    for i, (gb, _) in enumerate(got):
        for j, (wb, _) in enumerate(want):
            v = iou(np.asarray(gb, np.float64), np.asarray(wb, np.float64))
            if v >= iou_thresh:
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
                  want_sets: Sequence[Detections], *,
                  iou_thresh: float = 0.5,
                  conf_tol: float = 0.02) -> ParityReport:
    """Box and confidence parity of ``got_sets`` against ``want_sets``;
    the goldens gate takes the defaults, the packed-YCbCr path's parity
    against the pixels path IoU 0.8 and confidence tolerance 0.05."""
    report = ParityReport()
    for got, want in zip(got_sets, want_sets):
        report.images += 1
        report.want_total += len(want)
        report.got_total += len(got)
        for gi, wi, _ in match_detections(got, want, iou_thresh):
            report.box_matched += 1
            if abs(got[gi][1] - want[wi][1]) <= conf_tol:
                report.conf_matched += 1
    return report


def fidelity_gate(report: ParityReport, min_parity: float = 0.95) -> bool:
    """True iff both box and confidence parity reach ``min_parity``."""
    return (report.box_parity >= min_parity
            and report.conf_parity >= min_parity)
