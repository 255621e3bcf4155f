"""The card's time per frame served: the seconds in which the card ran
any kernel, copy or set during the window (the union of their intervals
in the device trace) over the frames whose detections reached a viewer in
the window, in milliseconds. What the operator pays for on the card; it
does not follow the host's pace, which the delivered rate does (PERF.md
section 7)."""


def read(run):
    frames = sum(run.load["received"])
    if run.trace is None or not frames:
        return None
    return 1e3 * run.trace["busy_s"] / frames
