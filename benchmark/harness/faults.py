"""Faults planted in the timed path, for the checks that ``correct``
catches them (``calibrate.py --faults`` on the card at a cell's size,
``tests/test_benchmark_faults.py`` on the CPU). Each wraps the serving
worker's device program (``serving/inferer.py`` ``_program``), which
maps a unit (a batch of frames) to its outputs, packed detections last.
"""

from __future__ import annotations


def _packed(outs):
    return outs[-1] if isinstance(outs, tuple) else outs


def _replace_packed(outs, packed):
    return outs[:-1] + (packed,) if isinstance(outs, tuple) else packed


def stale(program):
    """The step returns its state unchanged: each batch gets the outputs
    of the first batch of its size."""
    seen = {}

    def run(unit):
        outs = program(unit)
        return seen.setdefault(tuple(_packed(outs).shape), outs)
    return run


def half_batch(program):
    """Each batch's second half (rounded up) left out: no detections."""
    def run(unit):
        outs = program(unit)
        packed = _packed(outs).clone()
        packed[unit["n"] // 2:unit["n"]] = 0
        return _replace_packed(outs, packed)
    return run


def altered(program):
    """Every frame's answer altered where it is produced: its boxes moved
    right by 0.15 of the frame."""
    def run(unit):
        outs = program(unit)
        packed = _packed(outs).clone()
        packed[..., 0] += 0.15
        packed[..., 2] += 0.15
        return _replace_packed(outs, packed)
    return run


def chroma_swapped(program):
    """The decoded frames' Cb and Cr planes swapped before the device's
    chroma upsample and colour conversion (packed YCbCr units)."""
    def run(unit):
        if unit["kind"] == "ycbcr":
            g, batch = unit["geom"], unit["batch"]
            y = g["y_pw"] * g["y_ph"]
            c = g["c_pw"] * g["c_ph"]
            swapped = batch.clone()
            swapped[:, y:y + c] = batch[:, y + c:y + 2 * c]
            swapped[:, y + c:y + 2 * c] = batch[:, y:y + c]
            unit = dict(unit, batch=swapped)
        return program(unit)
    return run


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered,
          "chroma_swapped": chroma_swapped}
