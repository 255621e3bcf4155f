"""The publish stage's CPU time per frame served: the publish thread's
own CPU seconds inside its ``publish`` spans (the Meter's
``cpu_s_publish``, ``serving/inferer.py``: the JSON records, the
annotate tails and the hand-off to the event loop) in the window, over
the frames whose detections reached a viewer, in milliseconds."""


def read(run):
    frames = sum(run.load["received"])
    if not frames or "cpu_s_publish" not in run.meter:
        return None
    return 1e3 * run.meter["cpu_s_publish"] / frames
