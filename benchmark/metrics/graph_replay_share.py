"""The share of the device stage's units run by replaying CUDA graphs in
place of launching each kernel: the Meter's ``graph_replays`` over its
``batches`` in the window (``serving/inferer.py``, ``detector.py``
``ProgramGraphs``), in percent. None where the program counts no
replays (a program without them) or dispatched no unit."""


def read(run):
    units = run.meter.get("batches", 0)
    if not units or "graph_replays" not in run.meter:
        return None
    return 100.0 * run.meter["graph_replays"] / units
