"""Seconds from the process's start to the window's: imports, the
pictures and weights, the detector, the server's warm-up, the load
generator's start and the cell's warm traffic."""


def read(run):
    return run.setup_s
