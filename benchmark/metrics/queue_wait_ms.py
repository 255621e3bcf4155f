"""The batcher's queue wait per frame: the seconds from the router's
queueing of each frame to the hand-off of its gather to the decode
stage (the Meter's ``queue_wait_s``, ``serving/inferer.py``), over the
frames so handed off (``queued_frames``), in the window, in
milliseconds. The wait behind the previous gather's decode and dispatch,
plus the gather window."""


def read(run):
    frames = run.meter.get("queued_frames", 0)
    if not frames or "queue_wait_s" not in run.meter:
        return None
    return 1e3 * run.meter["queue_wait_s"] / frames
