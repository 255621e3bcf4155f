"""The host's time launching a unit's input work: the ``launch_input``
spans (``detector.py``: the unpack, the chroma upsample and the resize;
a ycbcr unit has two) that ended in the window, summed, over the units
dispatched (the Meter's ``batches``), in milliseconds. The device
thread's enqueue, not the card's work."""


def read(run):
    units = run.meter.get("batches", 0)
    spans = run.spans_in("launch_input")
    return 1e3 * sum(spans) / units if units and spans else None
