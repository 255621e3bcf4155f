"""The trunk's convolutions (bfloat16 on tensor cores) against their
roofline: their FLOPs for the frames completed in the traced window over
the bfloat16 peak, over the time of the kernels the stage map gives to
``trunk``, in percent."""


def read(run):
    t = run.trace
    kernel_s = t and t["stage_s"].get("trunk")
    if not kernel_s:
        return None
    peak = t["peaks"]["flops"]["bfloat16"]
    least = t["frames"] * run.work["trunk_flops"] / peak
    return 100.0 * least / kernel_s
