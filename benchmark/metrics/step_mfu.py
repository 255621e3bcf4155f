"""The whole step's share of the card's peak: for every frame completed
in the traced window, the least time its FLOPs take at the peak of their
type (the resample GEMMs' float32 ones at the float32 peak, the
convolutions' at the bfloat16 peak), summed, over the traced window, in
percent."""


def read(run):
    t = run.trace
    if not t or not t["frames"]:
        return None
    flops = t["peaks"]["flops"]
    least = t["frames"] * (run.work["resize_flops"] / flops["float32"]
                           + run.work["trunk_flops"] / flops["bfloat16"])
    return 100.0 * least / t["window_s"]
