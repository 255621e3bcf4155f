"""The device thread's time off the CPU inside dispatch, per unit: the
wall seconds of the ``device*`` spans that ended in the window less the
thread's CPU seconds inside them (the Meter's ``cpu_s_device``), over
the units dispatched (the Meter's ``batches``), in milliseconds. The
wait for the interpreter lock and in blocking driver calls; with the
device thread's CPU a unit it makes up ``dispatch_ms``."""


def read(run):
    units = run.meter.get("batches", 0)
    spans = run.spans_in("device*")
    if not units or not spans or "cpu_s_device" not in run.meter:
        return None
    return 1e3 * (sum(spans) - run.meter["cpu_s_device"]) / units
