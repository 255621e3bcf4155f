"""The CPU the publish thread burns waiting for the card, per frame
served: its own CPU seconds inside the ``readback_wait`` spans (the
Meter's ``cpu_s_readback_wait``, ``serving/inferer.py``: the wait on
each unit's readback event) in the window, over the frames whose
detections reached a viewer, in milliseconds. Near 0 where the wait
blocks; near the wait's wall time where it spins."""


def read(run):
    frames = sum(run.load["received"])
    if not frames or "cpu_s_readback_wait" not in run.meter:
        return None
    return 1e3 * run.meter["cpu_s_readback_wait"] / frames
