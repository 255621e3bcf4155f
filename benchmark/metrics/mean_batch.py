"""Frames per device batch in the window: the Meter's ``inferred_unique``
over its ``batches``."""


def read(run):
    batches = run.meter.get("batches", 0)
    return run.meter.get("inferred_unique", 0) / batches if batches else None
