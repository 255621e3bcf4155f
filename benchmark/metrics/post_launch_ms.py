"""The host's time launching a unit's post-processing: the
``launch_post`` spans (``detector.py``: the score filter, the top-k, the
NMS kernel's launch and the pack) that ended in the window, summed, over
the units dispatched (the Meter's ``batches``), in milliseconds. The
device thread's enqueue, not the card's work."""


def read(run):
    units = run.meter.get("batches", 0)
    spans = run.spans_in("launch_post")
    return 1e3 * sum(spans) / units if units and spans else None
