#!/usr/bin/env python3
"""Smoke run of the PyTorch port (infercam_onnx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing short JSON lines; any failure exits non-zero:

1. the card's name and power limit; every kernel in csrc/ built with nvcc
   for sm_90a;
2. each hand kernel against its plain PyTorch version on the card, on
   the shapes of the main path and edge cases: the keep masks must be
   bit-identical. Then the kernel's and the plain version's times;
3. the goldens gate: the float32 detector (TF32 off process-wide) on the
   committed frozen weights over resources/test_pics_synthetic must pass
   the >=95% box/confidence parity gate of tests/fixtures/goldens_twin_
   rfb320_synthetic.json; with TF32 turned on process-wide its packed
   output must not change;
4. the main path: Detector() (RFB-320, bfloat16) on a batch of 16 640x480
   frames through run_device(pack_output=True), with the kernels' launch
   counts set to 0 just before and read just after; the same scores
   through the plain NMS must give an identical packed output. Then
   ms/batch and frames/s, and one RFB-640 batch of 4;
5. the kernels line, the nvidia-smi line, and the final status line.

Needs one CUDA card and the repository's sources; imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WEIGHTS = REPO / "resources" / "weights" / "ultraface-twin.npz"
SYNTH_PICS = REPO / "resources" / "test_pics_synthetic"
GOLDENS = REPO / "tests" / "fixtures" / "goldens_twin_rfb320_synthetic.json"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations the NMS kernel spends on one (j, i) candidate pair: four
# max/min, two subtractions, two sign tests, one multiply (intersection),
# add + subtract (union), add EPS, divide, compare with max_iou.
NMS_OPS_PER_PAIR = 14
NMS_OPS_PER_BOX = 5  # two subtractions, two sign tests, one multiply


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, iters: int) -> dict:
    """Device time by kernel over ``iters`` calls of ``fn()``, from
    torch.profiler (CUPTI), and the wall time of the same window from
    CUDA events recorded around it. ``device_ms`` is None where the trace
    shows no device activity. ``idle_share`` is 1 - busy / wall over that
    one window; the profiler's own host cost is inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[2])
    total_us = sum(r[2] for r in rows)
    busy_ms = total_us / iters / 1e3 if total_us else None
    wall_ms = start.elapsed_time(end) / iters
    return {
        "device_ms": busy_ms,
        "wall_ms": wall_ms,
        "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
        "device_ops_per_iter": sum(r[1] for r in rows) / iters,
        "top": [[name[:64], count / iters, us / iters / 1e3]
                for name, count, us in rows[:8]],
    }


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    """Every csrc/ kernel (this slice has one), built with nvcc."""
    from infercam_onnx_tpu_torch import kernels
    from infercam_onnx_tpu_torch.ops import nms

    t0 = time.perf_counter()
    lib = kernels.build(nms.SOURCE)
    ptxas = [ln.strip()
             for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "smem" in ln]
    return {"build_s": round(time.perf_counter() - t0, 3),
            "libraries": [lib.name], "ptxas": {nms.SOURCE: ptxas}}


# -- phase 2: kernel vs plain ---------------------------------------------


def _clustered_boxes(rng, b: int, k: int):
    """[B, K, 4] corner boxes in clusters, so NMS suppresses a lot."""
    import numpy as np

    centers = rng.uniform(0.1, 0.9, size=(b, 12, 2))
    idx = rng.integers(0, 12, size=(b, k))
    cxy = np.take_along_axis(centers, idx[..., None], axis=1)
    cxy = cxy + rng.normal(0, 0.02, size=(b, k, 2))
    wh = rng.uniform(0.05, 0.2, size=(b, k, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


def nms_cases(device):
    """name -> (boxes_t [B,4,K], valid [B,1,K], max_iou) on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def case(boxes, valid, max_iou=0.5):
        return (torch.from_numpy(np.ascontiguousarray(
                    boxes.transpose(0, 2, 1))).to(device),
                torch.from_numpy(valid[:, None, :].astype(np.float32))
                .to(device), max_iou)

    cases = {}
    for b, k in ((16, 256), (4, 512), (3, 300), (2, 2), (2, 64), (1, 1024)):
        boxes = _clustered_boxes(rng, b, k)
        valid = rng.uniform(size=(b, k)) < 0.8
        cases[f"random_b{b}_k{k}"] = case(boxes, valid)
    # strict-IoU boundary: suppression needs iou > max_iou
    pair = np.array([[[0.0, 0.0, 0.2, 0.2], [0.1, 0.0, 0.3, 0.2]]],
                    np.float32)
    true_iou = (0.1 * 0.2) / (2 * 0.2 * 0.2 - 0.1 * 0.2 + 1e-7)
    for sign, tag in ((1, "above"), (-1, "below")):
        cases[f"boundary_{tag}"] = case(pair, np.ones((1, 2), bool),
                                        true_iou + sign * 1e-4)
    # tie-heavy: boxes snapped to a coarse grid, many exact duplicates
    # and exactly equal IoUs, degenerate and ill-formed boxes included
    grid = np.round(_clustered_boxes(rng, 8, 256) * 10) / 10
    cases["ties_b8_k256"] = case(grid.astype(np.float32),
                                 np.ones((8, 256), bool))
    return cases


def check_nms_kernel(device) -> dict:
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.ops import nms, postprocess

    out = {"cases": {}, "mismatches": 0, "max_abs_err": 0.0}
    for name, (boxes_t, valid, max_iou) in nms_cases(device).items():
        got = nms.greedy_suppress(boxes_t, valid, max_iou=max_iou)
        want = nms.greedy_suppress_reference(boxes_t, valid, max_iou=max_iou)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        out["cases"][name] = {"kept": int(got.sum()), "mismatches": bad}
        out["mismatches"] += bad
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((got - want).abs().max()))
    # the whole filter + NMS on confidence ties (few distinct levels)
    rng = np.random.default_rng(1)
    boxes = torch.from_numpy(_clustered_boxes(rng, 16, 4420)).to(device)
    conf = torch.from_numpy(
        (rng.integers(0, 8, size=(16, 4420)) / 8).astype(np.float32)
    ).to(device)
    ref = None
    for impl in ("scan", "xla", "kernel"):
        res = postprocess.batched_nms(conf, boxes, top_k=256, impl=impl)
        packed = torch.cat([res[0], res[1][..., None]], -1)
        if ref is None:
            ref, ref_n = packed, res[2]
        bad = int((packed != ref).sum() + (res[2] != ref_n).sum())
        out["cases"][f"batched_nms_ties_{impl}"] = {
            "count": int(res[2].sum()), "mismatches": bad}
        out["mismatches"] += bad
    return out


def time_nms(device) -> dict:
    """Kernel and plain version at the main path's shape (B=16, K=256)."""
    from infercam_onnx_tpu_torch.ops import nms

    boxes_t, valid, max_iou = nms_cases(device)["random_b16_k256"]
    b, _, k = boxes_t.shape
    # event timing of back-to-back wrapper calls includes the host's
    # launch cost; the profiler gives the kernel's own device time
    call_ms = time_ms(lambda: nms.kernel(boxes_t, valid, max_iou), 500, 20)
    prof = profile_device(lambda: nms.kernel(boxes_t, valid, max_iou), 50)
    kernel_ms = next((ms / count for name, count, ms in prof["top"]
                      if "nms_kernel" in name), None)
    plain_ms = time_ms(
        lambda: nms.greedy_suppress_reference(boxes_t, valid,
                                              max_iou=max_iou), 5, 1)
    keep = nms.kernel(boxes_t, valid, max_iou)
    words = (k + 63) // 64
    n_bytes = b * k * (4 + 1 + 1) * 4  # boxes and valid in, keep out
    ops = (b * (k * (k - 1) // 2 * NMS_OPS_PER_PAIR + k * NMS_OPS_PER_BOX)
           + b * k + int(keep.sum()) * words)  # scan: tests + row ORs
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return {"shape": [b, k], "ms": kernel_ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bytes": n_bytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes greedy NMS (torchvision's
            # nms is not installed and is not part of PyTorch)
            "library_ms": None}


# -- phase 3 and 4: the detector ------------------------------------------


def set_tf32(state: str) -> None:
    """Process-wide TF32 settings, through either of PyTorch's APIs."""
    import torch

    b = torch.backends
    if state == "off":
        b.cudnn.allow_tf32 = False
        b.cuda.matmul.allow_tf32 = False
    elif state == "on_legacy_api":
        b.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    elif state == "on_fp32_precision_api":
        b.cuda.matmul.fp32_precision = "tf32"
        b.cudnn.conv.fp32_precision = "tf32"
    elif state == "default":  # PyTorch's: convs may use TF32, matmuls not
        b.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("highest")
    else:
        raise ValueError(state)


def goldens_gate(device) -> dict:
    """The float32 detector on the frozen weights: the goldens gate with
    TF32 off process-wide; then its packed output on the synthetic
    pictures with TF32 on process-wide, through either API, which must be
    bit-identical (the detector scopes IEEE float32 itself). The float32
    trunk run outside that scope shows how far TF32 would move it."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig, full_float32
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.eval.goldens import (check_against_goldens,
                                                      load_directory_frames)
    from infercam_onnx_tpu_torch.ops.preprocess import preprocess_images

    det = Detector(DetectorConfig(variant="RFB-320", compute_dtype="float32",
                                  top_k=512, max_detections=256),
                   weights=str(WEIGHTS), device=device)
    frames = np.stack(list(load_directory_frames(str(SYNTH_PICS)).values()))
    set_tf32("off")
    out = {"gate_tf32": "off (cudnn.allow_tf32 = matmul.allow_tf32 = False)",
           **check_against_goldens(det, str(SYNTH_PICS), str(GOLDENS))}
    want = det.run_device(frames, pack_output=True).cpu()
    out["identical_with_tf32_on"] = {}
    for state in ("on_legacy_api", "on_fp32_precision_api"):
        set_tf32(state)
        got = det.run_device(frames, pack_output=True).cpu()
        out["identical_with_tf32_on"][state] = torch.equal(got, want)
    _, h, w, _ = frames.shape
    images = torch.from_numpy(frames).to(device)
    with torch.inference_mode():
        x = preprocess_images(images, *det.preprocessor.matrices(w, h))
        tf32 = det.model(x, det.priors)
        with full_float32():
            ieee = det.model(x, det.priors)
    out["unscoped_tf32_trunk_max_abs_diff"] = max(
        float((a - b).abs().max()) for a, b in zip(tf32, ieee))
    set_tf32("default")
    return out


def synthetic_batch(n: int, width: int, height: int):
    """[n, H, W, 3] uint8 frames from the four synthetic pictures (also
    mirrored, so frames differ within the batch)."""
    import numpy as np

    from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames

    pics = list(load_directory_frames(str(SYNTH_PICS),
                                      resize=(width, height)).values())
    frames = [pics[i % len(pics)] for i in range(n)]
    frames = [f[:, ::-1] if (i // len(pics)) % 2 else f
              for i, f in enumerate(frames)]
    return np.ascontiguousarray(np.stack(frames))


def check_packed(packed, min_confidence: float) -> dict:
    """Shape and sanity of a packed [B, D, 6] output."""
    import torch

    valid = packed[..., 5]
    counts = valid.sum(-1)
    conf = packed[..., 4]
    ok = bool(torch.isfinite(packed).all())
    ok &= bool(((valid == 0) | (valid == 1)).all())
    ok &= bool((valid[:, 1:] <= valid[:, :-1]).all())  # valid rows first
    ok &= bool(((conf > min_confidence) | (valid == 0)).all())
    ok &= bool(((conf[:, 1:] <= conf[:, :-1]) | (valid[:, 1:] == 0)).all())
    return {"ok": ok, "shape": list(packed.shape),
            "counts": [int(c) for c in counts]}


def main_path(device) -> dict:
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector, detect_program
    from infercam_onnx_tpu_torch.ops import nms

    det = Detector(device=device)  # RFB-320, bfloat16, random weights
    frames = synthetic_batch(16, 640, 480)
    det.warmup(16, 480, 640)

    nms.kernel.launches = 0
    packed = det.run_device(frames, pack_output=True)
    torch.cuda.synchronize()
    launches = {"nms": nms.kernel.launches}
    sanity = check_packed(packed, det.config.min_confidence)

    # the same frames through the plain NMS, and through the kernel again
    c = det.config
    images = torch.from_numpy(frames).to(device)
    r_h, r_w = det.preprocessor.matrices(640, 480)

    def program(impl):
        return detect_program(
            det.model, det.priors, images, r_h, r_w,
            min_confidence=c.min_confidence, max_iou=c.max_iou,
            top_k=c.top_k, max_detections=c.max_detections,
            pack_output=True, nms_impl=impl)

    plain = program("scan")
    again = program("kernel")
    torch.cuda.synchronize()
    identical = bool(torch.equal(plain, again) and torch.equal(packed, again))

    ms = time_ms(lambda: program("kernel"), 20)
    plain_nms_ms = time_ms(lambda: program("scan"), 3, 1)
    prof = profile_device(lambda: program("kernel"), 20)

    t0 = time.perf_counter()
    for _ in range(10):  # numpy frames in, packed detections on the host
        det.run_device(frames, pack_output=True).cpu()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3

    det640 = Detector(DetectorConfig(variant="RFB-640"), device=device)
    frames640 = synthetic_batch(4, 640, 480)
    det640.warmup(4, 480, 640)
    images640 = torch.from_numpy(frames640).to(device)
    packed640 = det640.run_device(images640, pack_output=True)
    ms640 = time_ms(lambda: det640.run_device(images640, pack_output=True),
                    20)
    return {
        "launches": launches, "sanity": sanity,
        "identical_kernel_vs_plain": identical,
        "ms_per_batch": ms, "frames_per_s": 16 / ms * 1e3,
        "ms_per_batch_plain_nms": plain_nms_ms,
        "host_ms_per_batch": host_ms,
        # busy and wall from the same profiled window of 20 batches
        "device_busy_ms_per_batch": prof["device_ms"],
        "profiled_wall_ms_per_batch": prof["wall_ms"],
        "device_idle_share": prof["idle_share"],
        "device_ops_per_batch": prof["device_ops_per_iter"],
        "top_device_ms": prof["top"],
        "rfb640_b4": {"ms_per_batch": ms640,
                      "sanity": check_packed(packed640, c.min_confidence)},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # without the repository's sources this fails before any output
    import infercam_onnx_tpu_torch  # noqa: F401

    device = torch.device("cuda", 0)
    smi = gpu_info()
    name, power = (s.strip() for s in smi.split(",", 1))
    emit({"phase": "gpu", "gpu": name, "power_limit": power,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit({"phase": "build", **build_kernels()})

    kcheck = check_nms_kernel(device)
    emit({"phase": "nms_kernel_vs_plain", **kcheck})
    if kcheck["mismatches"]:
        raise SystemExit("nms kernel disagrees with its plain version")
    ktime = time_nms(device)
    emit({"phase": "nms_time", "gpu": name, "power_limit": power, **ktime})
    if ktime["ms"] is None:
        raise SystemExit("the profiler recorded no nms_kernel device time")

    gold = goldens_gate(device)
    emit({"phase": "goldens", **gold})
    if not gold["passed"]:
        raise SystemExit("goldens gate failed")
    if not all(gold["identical_with_tf32_on"].values()):
        raise SystemExit("the float32 detector's output moved with the "
                         "process-wide TF32 setting")

    path = main_path(device)
    emit({"phase": "main_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", "batch": 16, "frame": [640, 480], **path})
    if not path["sanity"]["ok"] or not path["rfb640_b4"]["sanity"]["ok"]:
        raise SystemExit("main path output failed its sanity checks")
    if not path["identical_kernel_vs_plain"]:
        raise SystemExit("packed output differs between kernel and plain NMS")
    if path["launches"]["nms"] < 1:
        raise SystemExit("main path did not launch the nms kernel")

    emit({"kernels": [{
        "name": "nms_greedy_suppress", "route": "cuda",
        "source": "infercam_onnx_tpu_torch/csrc/nms.cu",
        "replaces": "infercam_onnx_tpu/ops/pallas/nms.py:45",
        "launches": path["launches"]["nms"],
        "max_abs_err": kcheck["max_abs_err"],
        "mismatches": kcheck["mismatches"],
        "ms": ktime["ms"], "plain_ms": ktime["plain_ms"],
        "bound_ms": ktime["bound_ms"], "bound_by": ktime["bound_by"],
        "library_ms": ktime["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
