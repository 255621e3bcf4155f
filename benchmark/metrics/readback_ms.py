"""The host's time starting a unit's readback: the ``readback`` spans
(``serving/inferer.py``: the pinned host tensors, the device-to-host
copies' enqueue and the event) that ended in the window, summed, over
the units dispatched (the Meter's ``batches``), in milliseconds."""


def read(run):
    units = run.meter.get("batches", 0)
    spans = run.spans_in("readback")
    return 1e3 * sum(spans) / units if units and spans else None
