"""Pairing records with frames, and the gaps `correct` compares."""

import json

import numpy as np
import pytest

from harness import compare
from harness.spec import BENCH_DIR

CFG = json.loads((BENCH_DIR / "configs" / "rfb320.json").read_text())


def _dets(*rows):
    return [(np.array(box, np.float64), c) for box, c in rows]


def _record(dets):
    return {"width": 320, "height": 240,
            "detections": [{"bbox": list(map(float, b)), "confidence": c}
                           for b, c in dets]}


DRAWS = [_dets(([0.1, 0.1, 0.2, 0.2], 0.9)),
         _dets(([0.5, 0.5, 0.6, 0.7], 0.8)),
         _dets(([0.3, 0.1, 0.4, 0.3], 0.7), ([0.7, 0.7, 0.9, 0.9], 0.6))]
SENT = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


def test_records_pair_with_the_frames_they_answer():
    # frames 0, 1, 2 answered, 3 shed, 4 and 5 answered
    records = [(t + 0.5, _record(DRAWS[j % 3]))
               for t, j in ((0, 0), (1, 1), (2, 2), (4, 4), (5, 5))]
    assert compare.assign(records, SENT, DRAWS) == [0, 1, 2, 4, 5]


def test_a_stale_or_early_answer_pairs_with_no_frame():
    # the first answer repeated: frame 3 is the next showing draw 0, and
    # it is sent after the second record arrived
    records = [(0.5, _record(DRAWS[0])), (1.5, _record(DRAWS[0])),
               (3.5, _record(DRAWS[0]))]
    assert compare.assign(records, SENT, DRAWS) == [0, None, 3]
    # an answer that arrives before its frame was sent
    assert compare.assign([(0.5, _record(DRAWS[1]))], SENT, DRAWS) == [None]


def test_empty_records_pair_with_the_earliest_empty_frame():
    draws = [[], _dets(([0.1, 0.1, 0.2, 0.2], 0.9)), []]
    records = [(0.5, _record([])), (2.5, _record([]))]
    assert compare.assign(records, SENT, draws) == [0, 2]


def test_gaps_of_exact_rounded_and_wrong_answers():
    conf = np.array([0.9, 0.52, 0.3])
    boxes = np.array([[0.1, 0.1, 0.2, 0.2], [0.5, 0.5, 0.6, 0.6],
                      [0.0, 0.0, 1.0, 1.0]])
    dets = _dets(([0.1, 0.1, 0.2, 0.2], 0.9), ([0.5, 0.5, 0.6, 0.6], 0.52))
    exact = compare.published(_record(dets))
    assert compare.record_gaps(exact, conf, boxes, dets, CFG) == (0, 0, 0)
    # rounding took the second below the threshold: a miss of its margin
    d, m, _ = compare.record_gaps(exact[:1], conf, boxes, dets, CFG)
    assert d == 0.0 and m == pytest.approx(0.02)
    # an answer left out misses every detection by its margin
    assert compare.record_gaps([], conf, boxes, dets, CFG) == \
        pytest.approx((0.0, 0.4, 0))
    # a moved box lies far from every candidate
    moved = [([0.25, 0.1, 0.35, 0.2], 0.9)] + exact[1:]
    d, m, off = compare.record_gaps(moved, conf, boxes, dets, CFG)
    assert d == pytest.approx(0.15) and m == pytest.approx(0.15)
    assert off == 1


def test_a_suppression_turned_the_other_way_is_no_miss():
    conf = np.array([0.80, 0.799])
    boxes = np.array([[0.1, 0.1, 0.3, 0.3], [0.12, 0.1, 0.32, 0.3]])
    dets = _dets((boxes[0], 0.80))
    other = [(list(boxes[1]), 0.799)]
    assert compare.record_gaps(other, conf, boxes, dets, CFG) == (0, 0, 0)
