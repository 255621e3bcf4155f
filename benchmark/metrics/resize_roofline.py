"""The float32 resample GEMMs (the ycbcr chroma upsample and the resize
to the network, which share kernel names) against their roofline: the
least time the card could take for the frames completed in the traced
window, the larger of their FLOPs over the float32 peak and their bytes
over the memory bandwidth, over the time of the kernels the stage map
gives to ``resize``, in percent."""


def read(run):
    t = run.trace
    kernel_s = t and t["stage_s"].get("resize")
    if not kernel_s:
        return None
    peaks = t["peaks"]
    least = t["frames"] * max(
        run.work["resize_flops"] / peaks["flops"]["float32"],
        run.work["resize_bytes"] / peaks["bytes_per_s"])
    return 100.0 * least / kernel_s
