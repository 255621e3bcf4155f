"""The device stage's host time per unit: the mean of every ``device*``
span (``serving/inferer.py``: the upload, the launch of the unit's
programs and the readback's enqueue, on the host's clock; not the card's
time) that ended in the window, in milliseconds."""


def read(run):
    spans = run.spans_in("device*")
    return 1e3 * sum(spans) / len(spans) if spans else None
