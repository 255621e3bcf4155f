"""The server's CPU time per frame served: the CPU seconds the run's
process (every thread of the port's server: ingest, decode, dispatch,
publish, the viewers' connections; the cameras and viewers run in a
child process and do not count) used in the window, over the frames
whose detections reached a viewer in the window, in milliseconds. The
host cores a camera costs; at a fixed offered rate below the knee the
work is fixed, so a leaner host path reads lower and the host's pace
does not enter. Taken with the device trace off."""


def read(run):
    frames = sum(run.load["received"])
    if not frames or not run.server_cpu_s:
        return None
    return 1e3 * run.server_cpu_s / frames
