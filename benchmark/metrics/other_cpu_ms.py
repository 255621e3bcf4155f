"""The server's CPU time per frame served outside the stage threads'
spans: the process's CPU seconds in the window (``server_cpu_s``) less
the five stage CPU totals of the Meter, over the frames whose detections
reached a viewer, in milliseconds. The event loop (ingest, router,
HTTP), the shim's decode pool, CUDA's own threads and, in a traced run,
the profiler's. With ``decode_cpu_ms``, ``dispatch_cpu_ms``,
``readback_wait_cpu_ms`` and ``publish_cpu_ms`` it adds up to the run's
server CPU time per frame."""

STAGE_TOTALS = ("cpu_s_decode", "cpu_s_upload", "cpu_s_device",
                "cpu_s_readback_wait", "cpu_s_publish")


def read(run):
    frames = sum(run.load["received"])
    if (not frames or not run.server_cpu_s
            or any(k not in run.meter for k in STAGE_TOTALS)):
        return None
    stages = sum(run.meter[k] for k in STAGE_TOTALS)
    return 1e3 * (run.server_cpu_s - stages) / frames
