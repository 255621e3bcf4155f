"""The hand NMS kernel (``csrc/nms.cu``) against its roofline: the bytes
of each completed frame's candidates read and keep mask written, over the
memory bandwidth, over the kernel's time in the traced window, in
percent."""


def read(run):
    t = run.trace
    kernel_s = t and t["stage_s"].get("nms")
    if not kernel_s:
        return None
    least = t["frames"] * run.work["nms_bytes"] / t["peaks"]["bytes_per_s"]
    return 100.0 * least / kernel_s
