"""The device stage's CPU time per frame served: the device thread's own
CPU seconds inside its ``device*`` spans (the Meter's ``cpu_s_device``,
``serving/inferer.py``: the launches of each unit's programs and the
readback's enqueue) in the window, over the frames whose detections
reached a viewer, in milliseconds."""


def read(run):
    frames = sum(run.load["received"])
    if not frames or "cpu_s_device" not in run.meter:
        return None
    return 1e3 * run.meter["cpu_s_device"] / frames
