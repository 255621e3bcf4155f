"""The decode stage's CPU time per frame served: the decode thread's own
CPU seconds inside its ``decode`` and ``upload`` spans (the Meter's
``cpu_s_decode`` + ``cpu_s_upload``, ``serving/inferer.py``) in the
window, over the frames whose detections reached a viewer, in
milliseconds. The shim's decode pool runs on threads of its own and
counts in ``other_cpu_ms``."""


def read(run):
    frames = sum(run.load["received"])
    if not frames or "cpu_s_decode" not in run.meter:
        return None
    return 1e3 * (run.meter["cpu_s_decode"]
                  + run.meter.get("cpu_s_upload", 0.0)) / frames
