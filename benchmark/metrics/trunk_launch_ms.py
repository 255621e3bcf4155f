"""The host's time launching a unit's trunk: the ``launch_trunk`` spans
(``detector.py``: the model call) that ended in the window, summed, over
the units dispatched (the Meter's ``batches``), in milliseconds. The
device thread's enqueue, not the card's work."""


def read(run):
    units = run.meter.get("batches", 0)
    spans = run.spans_in("launch_trunk")
    return 1e3 * sum(spans) / units if units and spans else None
