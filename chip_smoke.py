#!/usr/bin/env python3
"""Smoke run of the PyTorch port (infercam_onnx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing short JSON lines; any failure exits non-zero:

1. the card's name and power limit; every kernel in csrc/ built with nvcc
   for sm_90a;
2. each hand kernel against its plain PyTorch version on the card, on
   the shapes of the main path and edge cases: the keep masks must be
   bit-identical. Then the NMS kernel's and the plain version's times at
   three inputs: (a) random clustered boxes, B=16, K=256, 80% valid; (b)
   the candidates the main path feeds it, captured from batched_nms on
   the frozen weights (RFB-320, top_k 256, 16 synthetic frames); (c)
   B=16, K=1024 clustered boxes; (d) the candidates the tiled path feeds
   it, captured the same way from TiledDetector.run_device (16 1920x1080
   frames, 2x2 grid: the 4 x 4,420 merged candidates cut to top_k 256).
   Each with its own bound. A second build of the kernel with its time
   stamps turned on splits its time into phase 1 and the scan;
3. the goldens gate: the float32 detector (TF32 off process-wide) on the
   committed frozen weights over resources/test_pics_synthetic must pass
   the >=95% box/confidence parity gate of tests/fixtures/goldens_twin_
   rfb320_synthetic.json; with TF32 turned on process-wide its packed
   output must not change;
4. the main path: Detector (RFB-320, bfloat16, random weights from seed 0
   given explicitly, so the weights chain never reads the machine's cache)
   on a batch of 16 640x480 frames through run_device(pack_output=True),
   with the kernels' launch
   counts set to 0 just before and read just after; the same scores
   through the plain NMS must give an identical packed output. Then
   ms/batch and frames/s, and one RFB-640 batch of 4;
4a. native_decode: the port's libjpeg shim built with g++ (which libjpeg,
   its version, the thread count and the cores); its RGB decode of the
   four synthetic pictures against PIL's at scales 1, 2, 4 and 8; the
   host decode of a batch of 16 640x480 frames four ways (RGB, packed
   YCbCr at scales 1 and 2, PIL) and the bytes each sends to the card;
4b. ycbcr_path: Detector.run_device_ycbcr_packed on those 16 frames'
   packed planes, at scales 1 and 2: box parity >= 0.9 (IoU 0.8,
   confidences within 0.05) against run_device on the shim's RGB decode
   of the same bytes at scale 1, one NMS launch per call (its count set
   to 0 just before), ms per batch, host round trip and the profiler's
   device time of the whole program and of the chroma upsample + colour
   tail alone; the float32 program on the card against the CPU (counts
   equal, boxes within 1e-5, confidences within 5e-5);
4c. annotate_path: the device annotate tail on those 16 frames
   (RFB-320 bf16, frozen weights): run_device_annotated (pixels) and
   run_device_ycbcr_annotated (packed planes, scale 1), one NMS launch a
   call; each frame's coefficients entropy-coded (encode_coefs) and
   decoded within a mean absolute difference of 4 of the host's draw +
   encode_rgb; the packed detections bit-identical to the detection-only
   program's; the float32 programs on the card against the CPU
   (coefficients >= 99.9% equal, never 2 apart; detections as in 4b) and
   unmoved with TF32 on through either API; ms per batch in turns with
   the detection-only programs, the tail's and the label layer's device
   time and ops, bytes read back, host encode_coefs against draw +
   encode_rgb per frame;
4d. coefficients_path: detect_from_coefficients and the splice transcode
   (k=768) on the same frames' entropy-decoded blocks: box parity >= 0.9
   with the pixels path, every block the splice did not touch bit-exact,
   every touched block selected where meta[0] <= k and the budget filled
   where a frame overflows it, float32 card against CPU (the splice's meta equal, its
   coefficients as in 4c), one NMS launch a call, ms per batch in turns,
   read_coefficient_batch's and the 12-bit packing's host ms;
4e. tiled_path: TiledDetector (2x2 grid, overlap 0.2, RFB-320 bf16,
   frozen weights) on 16 1920x1080 quality-90 4:2:0 JPEGs made from the
   synthetic pictures (plain and mirrored, PIL bilinear upscale), decoded
   at scales 1 (1920x1080) and 2 (960x540), through run_device,
   run_device_ycbcr_packed and run_device_ycbcr_rows (one device tensor a
   frame): one NMS launch a call; pixels and packed outputs bit-identical
   to the same programs with the plain scan; rows bit-identical to
   packed; a 1x1 grid against the untiled program (counts equal, boxes
   within 1e-5); the float32 ycbcr program against the float32 pixels
   one at scale 1 by the JAX package's tiled bar, which it holds at
   float32 and full decode (counts within 2 a frame, the top three
   quarters of the boxes within 5e-3), the bf16 programs' agreement and
   box parity at both scales shown beside it (bf16 rounding flips
   near-tie suppressions; at scale 2 the shim's chroma fold moves the
   colours); the float32 program on the card against the CPU on 2 frames
   at 1920x1080 (counts equal, boxes within 1e-5, confidences within
   5e-5), unmoved by TF32. ms per batch
   in turns with the untiled program, the profiler's device busy time,
   ops and top ops, and the bytes each upload route sends;
4f. link_probe: serving/link.py's probes on the card (probe_h2d_mbps,
   probe_tiled_route_ms at its default geometry and at a batch of 16
   1080p frames' packed planes) and the decision tables of the default
   EngineConfig and of coefficients decode with device annotation;
4g. sharded_path: ShardedDetector (RFB-320, bf16 and float32, frozen
   weights) on the 16 640x480 frames of 4b, every program of Detector on
   card-resident inputs: over [cuda:0] bit-identical to Detector, one NMS
   launch a call; over [cuda:0, cuda:0] (two replicas, four streams, one
   card) bit-identical to Detector on each shard's 8 rows concatenated,
   two NMS launches a call, and in float32 within ROADMAP C.3 (counts
   equal, boxes 1e-5, confidences 5e-5) of the 16-row call. The tiled
   mesh modes over the two replicas on the 1080p JPEGs of 4e (pixels and
   packed planes): batch_sharded_out two NMS launches a call and
   bit-identical to the plain TiledDetector on each shard's 8 frames; the
   default mode (32 of the 64 tiles a replica) one launch a call, in
   float32 within C.3 of the plain TiledDetector. ms a batch in turns
   (plain B=16, 1 x 16, 2 x 8) and the host ms a call;
4h. graph_path: the ONNX graph runtime, GraphDetector on the committed
   export of the frozen twin (tests/fixtures/ultraface_twin_rfb320.onnx,
   float32) on the 16 frames of 4b: run_device with one NMS launch a call
   and an output bit-identical to the plain scan's, within 1e-4 of the
   native float32 Detector, the goldens gate through it, float32 card
   against CPU on 2 frames by C.3 and unmoved with TF32 on; its
   run_device_ycbcr_packed, run_device_annotated,
   run_device_ycbcr_annotated and run_device_coefficients_arrays one
   launch each and within 1e-4 of the native detector's same programs;
   to_mesh([cuda:0, cuda:0]) bit-identical per 8-row shard, two launches
   a call; ms a batch in turns with the native float32 detector, host ms
   a call of each, the profiler's device time and ops a call, and the
   graph's nodes a call;
4i. qdq_path: GraphDetector on the committed int8 QDQ export of the same
   twin (tests/fixtures/ultraface_twin_rfb320_qdq.onnx, float32) on the
   16 frames of 4b: every program one NMS launch a call, run_device's
   output bit-identical to the plain scan's, to_mesh over two replicas
   per shard with two launches, card against CPU on 2 frames by
   qdq_agreement (the CPU tests' bar), no host copy a call; box parity
   with the float GraphDetector, nodes a call and how many are Q/DQ, ms a
   batch in turns with the float GraphDetector, host ms a call, the
   profiler's device time and ops a batch;
4j. graph_ops: each other op family of the graph runtime on the card
   against the port on the CPU, float32 with TF32 off: the committed
   CRNN, norm/activation and einsum/logsoftmax/cumsum exports,
   gather/scatter, GridSample and RoiAlign, a data-dependent If and Loop
   inside torch.func.vmap and a Scan, and MatMulInteger, ConvInteger and
   QLinearConv bit-equal; each its largest difference and tolerance;
4k. weights_chain: under a private XDG_CACHE_HOME (restored after), the
   committed twin export at cached_model_path("RFB-320") and a float32
   Detector built with no weights on the 16 frames of 4: its packed output
   bit-identical to the detector given params_from_onnx of the export, one
   NMS launch a call, the .npz cache written; a second detector from that
   cache and a third from a truncated one (rebuilt) bit-identical again;
   the seconds of one offline load_or_download_params("slim-320") miss,
   with the stock downloader pointed at a closed local port;
4l. goldens_cli: ``python -m infercam_onnx_tpu_torch.eval.goldens check``
   on the card (float32, frozen weights, the committed fixture) exits 0
   with the goldens phase's counts and parities; ``make`` into a temp
   file, then ``check`` against it, gives parity 1.0; the float32 trunk's
   outputs through ops/reference_impl.postprocess (the reference's
   semantics in NumPy) equal the packed kernel output by ROADMAP C.3;
4m. onnx_run: ``python -m infercam_onnx_tpu_torch.onnx_run`` on the twin
   and CRNN exports, ``--device cuda --runs 20`` and on the CPU: each exits
   0, the card's outputs within 1e-4 of the CPU's, ms a run printed;
4n. model_api: the model-level API as a JAX user writes it, float32,
   RFB-320 and RFB-640 (random weights of seed 0) on the 16 frames of 4:
   ops.Preprocessor(w, h)(frames) -> UltraFace.create(variant, rng=0)(x)
   -> ops.batched_postprocess -> pack_detections bit-identical to
   Detector(..., params=model.params).run_device, one NMS launch a
   batched_postprocess call, the functional forward(model.params, x,
   model.priors) = model(x), model(x, compute_dtype=bfloat16) within 0.03
   of the bfloat16 Detector's trunk; ms a batch in turns with run_device;
5. the serving tier: the port's server in this process (RFB-320,
   bfloat16, frozen weights, pixels decode, host annotation) under 16
   senders at 30 fps for 10 s, with a /detections viewer per stream and a
   /face_stream viewer on one; senders and viewers run in a child process
   (``chip_smoke.py --load-generator HTTP_PORT SOCKET_PORT``). It reports
   frames sent, inferred and dropped, frames/s, batch sizes, e2e latency
   and stage means; NMS launches must equal batches dispatched, every
   /face_stream part must decode to 640x480, and in a check round
   before the window, with the card held back before each readback, the
   detections the worker published must be bit-identical to run_device
   on the same padded batches outside the worker;
5a. serve_ycbcr: the same serve phase, traffic and checks with
   decode_mode="ycbcr" at scale 1: detection-only frames take the packed
   planes, stream 0's (it has a /face_stream viewer) the pixels path, and
   checked batches must equal run_device_ycbcr_packed (or run_device);
5b. serve_ycbcr_annotate and 5c. serve_coefficients: the same traffic and
   checks with annotate_mode="device", in ycbcr and coefficients decode:
   stream 0's frames take the annotated unit (ycbcr_annot, or the splice
   coef_annot), the others the detection-only one. In the check round
   every unit's records must equal its program's outputs on the same
   padded batch outside the worker, and each of stream 0's /face_stream
   parts the JPEG made from them (encode_coefs, or the splice), with the
   card held back after every program; the splice fallbacks are counted;
5d. serve_tiled: the server in ycbcr decode with device annotation,
   tile_min_pixels 921,600 (1280x720), a 2x2 grid, tiled_upload "auto",
   under 4 senders x 15 fps of the 1080p JPEGs of 4e for 10 s: stream 0's
   frames (it has a /face_stream viewer) take a tiled pixels unit drawn
   on the host, the others ycbcr_tiled or ycbcr_tiled_rows, as the link
   probe picks; the check round holds their records to TiledDetector's
   programs on the same padded batches, every face part must be
   1920x1080, and NMS launches must equal batches.
   Every serve phase runs with link_adaptive on, records /stats "link",
   and fails if the probe moved its decode or annotate mode;
5e. serve_lockstep: the card's compute mode (an exclusive-process card
   fails the phase), then ``cluster_launch.py --no-supervise``: two serve
   processes on cuda:0 in one gloo group with lockstep dispatch (RFB-320
   float32, frozen weights, pixels decode, host annotation), each fed by a
   load generator of its own (2 senders x 30 fps of the synthetic 640x480
   JPEGs) for 1 s and then a 10 s window. Each member must serve both its
   streams; every published record must equal the plain float32 detector
   on one of the four pictures by C.3; each member's NMS launches must
   equal its dispatches, padding rounds included. It reports each
   member's frames/s, drops, e2e p50/p99 (over the meter's 2 s windows)
   and member 0's coordinator rounds;
5f. serve_graph (run after 4h, before 5): the serve phase of 5 (pixels
   decode, host annotation, 16 x 30 fps of 640x480) with GraphDetector on
   the export of 4h in place of the native detector, with the same
   reports and checks; 5g. serve_qdq (after 5f) the same with the int8
   QDQ export of 4i;
5h. serve_pixels_annotate (after 5c): the traffic and checks of 5 with
   pixels decode and device annotation: stream 0's frames take the
   annotated pixels unit, whose face parts must equal encode_coefs of its
   program's outputs;
5i. serve_cli_throughput (after 5e): ``python -m
   infercam_onnx_tpu_torch.serve --preset throughput`` (ycbcr decode at
   scale 2) on the frozen weights as a child process, driven by ``python
   -m infercam_onnx_tpu_torch.loadgen`` (16 x 30 fps for 10 s): frames
   inferred, no sender errored, and the /stats NMS launches equal its
   batches over the load;
6. the whole run's seconds (and the new phases'), the kernels line, the
   nvidia-smi line, and the final status line.

Needs one CUDA card and the repository's sources; imports nothing of JAX.

    python3 chip_smoke.py --serve-turns PARENT_DIR

runs only the pixels/host and ycbcr/device serve phases, of the checkout
at PARENT_DIR and of this one, in turns (parent, this, this, parent).
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import signal
import subprocess
import sys
import tempfile
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


STARTED = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended (``t_s``,
    seconds since the script started)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - STARTED, 1)}
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
    per_iter = [[name[:64], count / iters, us / iters / 1e3]
                for name, count, us in rows]
    return {
        "device_ms": busy_ms,
        "wall_ms": wall_ms,
        "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
        "device_ops_per_iter": sum(r[1] for r in rows) / iters,
        "top": per_iter[:8],
        "rows": per_iter,
    }


def kernel_ms(prof: dict, name: str) -> float | None:
    """Device ms per launch of the kernels whose name holds ``name``."""
    hits = [(count, ms) for key, count, ms in prof["rows"] if name in key]
    launches = sum(c for c, _ in hits)
    return sum(ms for _, ms in hits) / launches if launches else None


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    """Every csrc/ kernel (this slice has one), built with nvcc, and the
    native JPEG shim, built with g++, at the same time."""
    from concurrent.futures import ThreadPoolExecutor

    from infercam_onnx_tpu_torch import kernels
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms

    def timed(fn, *args):
        t0 = time.perf_counter()
        return fn(*args), round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        nms_build = pool.submit(timed, kernels.build, nms.SOURCE)
        shim_build = pool.submit(timed, native_jpeg.build)
        (lib, nms_s), ((shim, _), shim_s) = (nms_build.result(),
                                              shim_build.result())
    ptxas = [ln.strip()
             for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "smem" in ln]
    return {"build_s": round(time.perf_counter() - t0, 3),
            "nvcc_s": nms_s, "gxx_s": shim_s,
            "libraries": [lib.name, shim.name], "ptxas": {nms.SOURCE: ptxas}}


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
    # the launch's cluster sizing (B=1, 64) and a cross-tile merge's K
    rng = np.random.default_rng(2)
    for b, k in ((1, 256), (64, 256), (16, 1024)):
        boxes = _clustered_boxes(rng, b, k)
        valid = rng.uniform(size=(b, k)) < 0.8
        cases[f"random_b{b}_k{k}"] = case(boxes, valid)
    # valid masks and boxes the kernel must take as the plain version does
    k = 256
    boxes = _clustered_boxes(rng, 16, k)
    dense = rng.uniform(size=(16, k)) < 0.8
    prefix = np.zeros((16, k), bool)
    prefix[:, :k // 8] = True
    prefix[:, k // 8::37] = True  # a few strays after a short prefix
    cases["sparse_prefix_b16_k256"] = case(boxes, prefix)
    cases["all_invalid_b16_k256"] = case(boxes, np.zeros((16, k), bool))
    nan_first = dense.copy()
    nan_first[:, 0] = False  # a NaN confidence sorts first, invalid
    cases["invalid_first_b16_k256"] = case(boxes, nan_first)
    nan = boxes.copy()
    nan[:, 3::7, 1] = np.nan  # IoU NaN: never suppresses
    nan[:, 0, 2] = np.nan
    cases["nan_boxes_b16_k256"] = case(nan, dense)
    dup = boxes.copy()
    dup[:, k // 2:] = dup[:, :k // 2]  # exact copies: IoU 1
    dup[:, 1:9] = dup[:, :1]
    cases["duplicates_b16_k256"] = case(dup, np.ones((16, k), bool))
    # the kernel decides +-0 intersections without dividing: zero-area
    # and zero boxes, at thresholds where +-0 IoUs do and do not suppress
    flat = boxes.copy()
    flat[:, 10:20, 2:] = flat[:, 10:20, :2]
    flat[:, 20:30] = 0.0
    for miou, tag in ((0.0, "zero"), (-0.5, "negative")):
        cases[f"{tag}_max_iou_b16_k256"] = case(flat, dense, miou)
    return cases


def check_nms_kernel(device) -> dict:
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.ops import nms, postprocess

    out = {"cases": {}, "mismatches": 0, "max_abs_err": 0.0,
           "cases_not_launched_once": 0}
    for name, (boxes_t, valid, max_iou) in nms_cases(device).items():
        before = nms.kernel.launches
        got = nms.greedy_suppress(boxes_t, valid, max_iou=max_iou)
        launches = nms.kernel.launches - before
        want = nms.greedy_suppress_reference(boxes_t, valid, max_iou=max_iou)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        out["cases"][name] = {"kept": int(got.sum()), "mismatches": bad,
                              "launches": launches}
        out["mismatches"] += bad
        out["cases_not_launched_once"] += launches != 1
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
    out["cluster_plans"] = {
        f"b{b}_k{k}": nms.kernel.cluster_plan(b, k)
        for b, k in ((1, 1024), (16, 256), (16, 1024), (64, 1024))}
    return out


def captured_nms_input(program, what: str):
    """The candidates ``program()`` hands the NMS kernel, captured from
    batched_nms; it must call the kernel once."""
    from infercam_onnx_tpu_torch.ops import nms

    captured = []
    real = nms.kernel

    def capture(boxes_t, valid, max_iou):
        captured.append((boxes_t.clone(), valid.clone(), max_iou))
        return real(boxes_t, valid, max_iou)

    nms.kernel = capture
    try:
        program()
    finally:
        nms.kernel = real
    if len(captured) != 1:
        raise SystemExit(f"{what} called the nms kernel {len(captured)} "
                         f"times, not once")
    return captured[0]


def nms_inputs(device, hd: list[bytes]) -> dict:
    """The four inputs the NMS kernel is timed at: (b) the frozen weights
    (RFB-320, bfloat16, top_k 256) on 16 synthetic 640x480 frames, (d) on
    the 16 1080p JPEGs ``hd`` through a 2x2 TiledDetector."""
    import numpy as np

    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.parallel.tiling import TiledDetector

    cases = nms_cases(device)
    det = Detector(weights=str(WEIGHTS), device=device)
    tiled = TiledDetector(det, HD, grid=(2, 2), overlap=0.2)
    frames = np.stack(native_jpeg.load().decode_batch(hd))
    return {"a_random_b16_k256": cases["random_b16_k256"],
            "b_main_path_b16_k256": captured_nms_input(
                lambda: det.run_device(synthetic_batch(16, 640, 480),
                                       pack_output=True), "the main path"),
            "c_clustered_b16_k1024": cases["random_b16_k1024"],
            "d_tiled_path_b16_k256": captured_nms_input(
                lambda: tiled.run_device(frames, pack_output=True),
                "the tiled path")}


def nms_work(boxes_t, valid, keep) -> dict:
    """Bytes and operations these inputs need, and the bound they set.

    Per image, with v valid candidates and n = last valid index + 1:
    operations = 14 * v(v-1)/2 (one IoU test per valid pair) + 5 * v (the
    valid boxes' areas) + n (validity tests in the scan) + one OR per kept
    candidate and later 64-candidate word below n; bytes = 4 * K (valid
    read) + 16 * v (the valid boxes read) + 4 * K (keep written).
    bound_ms = max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)."""
    import torch

    ok = valid[:, 0] > 0.5
    b, k = ok.shape
    idx = torch.arange(k, device=ok.device)
    v = ok.sum(-1)
    n = torch.where(ok, idx + 1, 0).amax(-1)
    later_words = ((n[:, None] + 63) // 64 - idx // 64 - 1).clamp(min=0)
    kept = keep[:, 0] > 0.5
    scan = int(n.sum()) + int((kept * later_words).sum())
    ops = (int((v * (v - 1) // 2).sum()) * NMS_OPS_PER_PAIR
           + int(v.sum()) * NMS_OPS_PER_BOX + scan)
    n_bytes = 4 * b * k + 16 * int(v.sum()) + 4 * b * k
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return {"valid": int(v.sum()), "kept": int(kept.sum()),
            "bytes": n_bytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def nms_device_ms(kern, boxes_t, valid, max_iou) -> float | None:
    """Device ms per launch of the NMS kernel ``kern`` (an NmsKernel) on
    one input, from the profiler over 50 calls."""
    prof = profile_device(lambda: kern(boxes_t, valid, max_iou), 50)
    return kernel_ms(prof, "nms_kernel")


def time_nms(device, inputs: dict) -> dict:
    """Per input: the kernel's device time (profiler), the time of
    back-to-back wrapper calls (CUDA events, host launch cost included),
    the plain version's time, and the bound."""
    import torch

    from infercam_onnx_tpu_torch.ops import nms

    out = {}
    for name, (boxes_t, valid, max_iou) in inputs.items():
        keep = nms.kernel(boxes_t, valid, max_iou)
        rec = {"shape": [boxes_t.shape[0], boxes_t.shape[2]],
               "ms": nms_device_ms(nms.kernel, boxes_t, valid, max_iou)}
        rec["call_ms"] = time_ms(lambda: nms.kernel(boxes_t, valid, max_iou),
                                 500, 20)
        rec["plain_ms"] = time_ms(
            lambda: nms.greedy_suppress_reference(boxes_t, valid,
                                                  max_iou=max_iou), 5, 1)
        rec.update(nms_work(boxes_t, valid, keep))
        # no single PyTorch call computes greedy NMS (torchvision's nms is
        # not installed and is not part of PyTorch)
        rec["library_ms"] = None
        torch.cuda.synchronize()
        out[name] = rec
    return out


# Turns on the NMS_STAMP(slot) points of csrc/nms.cu in a second build:
# thread 0 of each cluster's first CTA writes %globaltimer and clock64()
# at five points, which nms_read_stamps copies out.
STAMP_HEADER = """#include <cuda_runtime.h>
__device__ unsigned long long nms_stamps[64 * 16];
__device__ __forceinline__ void nms_stamp(int b, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (b < 64) {
    nms_stamps[b * 16 + slot] = t;
    nms_stamps[b * 16 + 8 + slot] = (unsigned long long)clock64();
  }
}
extern "C" int nms_read_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, nms_stamps,
                                   n * sizeof(unsigned long long));
}
#define NMS_STAMP(slot) if (rank == 0 && threadIdx.x == 0) nms_stamp(b, slot)
"""
STAMP_POINTS = ("start", "phase1_done", "after_phase1_barrier", "scan_done",
                "end")


def stamped_nms_source() -> pathlib.Path:
    """csrc/nms.cu with its stamps turned on, written into the build
    directory."""
    from infercam_onnx_tpu_torch import kernels
    from infercam_onnx_tpu_torch.ops import nms

    out = kernels.BUILD_DIR / "nms_stamped.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(STAMP_HEADER + (kernels.CSRC / nms.SOURCE).read_text())
    return out


def nms_phase_split(device, inputs: dict, iters: int = 30) -> dict:
    """The stamped build's time per part, mean over images and launches
    (the first 5 launches are warm-up): ns from %globaltimer, cycles from
    clock64() on the same SM, and the span from the first image's start
    to the last image's end of each launch."""
    import ctypes

    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.ops import nms

    kern = nms.NmsKernel(source=str(stamped_nms_source()))
    lib = kern.library()
    lib.nms_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nms_read_stamps.restype = ctypes.c_int
    parts = [f"{a}->{b}" for a, b in zip(STAMP_POINTS, STAMP_POINTS[1:])]
    out = {}
    for name, (boxes_t, valid, max_iou) in inputs.items():
        b = boxes_t.shape[0]
        buf = np.zeros(b * 16, np.uint64)
        ns, cycles, spans, bad = [], [], [], 0
        want = nms.greedy_suppress_reference(boxes_t, valid, max_iou=max_iou)
        for it in range(iters):
            got = kern(boxes_t, valid, max_iou)
            torch.cuda.synchronize()
            if lib.nms_read_stamps(buf.ctypes.data, b * 16) != 0:
                raise SystemExit("reading the nms stamps failed")
            bad += int((got != want).sum())
            st = buf.reshape(b, 16).astype(np.int64)
            if it >= 5:
                ns.append(np.diff(st[:, :5], axis=1))
                cycles.append(np.diff(st[:, 8:13], axis=1))
                spans.append(st[:, 4].max() - st[:, 0].min())
        ns, cycles = np.concatenate(ns), np.concatenate(cycles)
        out[name] = {
            "mismatches": bad,
            "ns": dict(zip(parts, ns.mean(0).tolist())),
            "cycles": dict(zip(parts, cycles.mean(0).tolist())),
            "launch_span_ns": float(np.mean(spans)),
            "sm_ghz": float(cycles.sum() / max(ns.sum(), 1)),
        }
    return out


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
    trunk called with TF32 on outside the detector's scope is reported
    beside it: the model scopes IEEE float32 itself too (an entry point
    since it has JAX's ``model(x)``), so the difference reads 0.0."""
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
    from infercam_onnx_tpu_torch.models.ultraface import init_params
    from infercam_onnx_tpu_torch.ops import nms

    # RFB-320, bfloat16, random weights given explicitly: the weights chain
    # would read the card machine's cache
    random_rfb = init_params(0, background_bias=0.75, arch="RFB")
    det = Detector(params=random_rfb, device=device)
    frames = synthetic_batch(16, 640, 480)
    det.warmup(16, 480, 640, pack_output=True)

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
    nms_ms = kernel_ms(prof, "nms_kernel")

    t0 = time.perf_counter()
    for _ in range(10):  # numpy frames in, packed detections on the host
        det.run_device(frames, pack_output=True).cpu()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3

    det640 = Detector(DetectorConfig(variant="RFB-640"), params=random_rfb,
                      device=device)
    frames640 = synthetic_batch(4, 640, 480)
    det640.warmup(4, 480, 640, pack_output=True)
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
        "nms_device_ms_per_batch": nms_ms,
        "nms_share_of_busy": nms_ms / prof["device_ms"],
        "top_device_ms": prof["top"],
        "rfb640_b4": {"ms_per_batch": ms640,
                      "sanity": check_packed(packed640, c.min_confidence)},
    }


# -- phase 4a and 4b: the native decode and the packed-YCbCr path -----------

DECODE_REPS = 7  # host timings: the median of this many batches


def synthetic_jpegs(n: int) -> list[bytes]:
    """n 640x480 4:2:0 JPEGs (quality 95) of the synthetic pictures, plain
    and mirrored: the frames of phase 4 as a sender would send them."""
    from infercam_onnx_tpu_torch import codec

    return [codec.encode_rgb(f) for f in synthetic_batch(n, 640, 480)]


def host_ms(fn, reps: int = DECODE_REPS) -> float:
    """Median host wall time of ``fn()`` in ms, after one warm-up call."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def native_decode(jpegs: list[bytes]) -> dict:
    """The shim against PIL on the four synthetic pictures at scales 1-8,
    and the host decode of ``jpegs`` (16 640x480 frames) four ways."""
    import numpy as np
    import PIL
    from PIL import features

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg

    shim = native_jpeg.load()
    out = {"shim": shim.info, "pillow": PIL.__version__,
           "pillow_libjpeg_turbo": features.version("libjpeg_turbo"),
           "vs_pil": {}}
    pics = [p.read_bytes() for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    for scale in (1, 2, 4, 8):
        got = codec.decode_batch(pics, scale)
        want = [codec._pil_decode(d, scale) for d in pics]
        same_shape = all(g.shape == w.shape for g, w in zip(got, want))
        diff = [np.abs(g.astype(np.int16) - w) for g, w in zip(got, want)
                if g.shape == w.shape]
        out["vs_pil"][scale] = {
            "shapes_equal": same_shape,
            "max_abs_diff": max(int(d.max()) for d in diff) if diff else None,
            "share_differing": (sum(int((d > 0).sum()) for d in diff)
                                / sum(d.size for d in diff)) if diff else None}
    n = len(jpegs)
    rgb_bytes = n * 640 * 480 * 3
    timing = {
        "frames": n,
        "rgb_ms": host_ms(lambda: shim.decode_batch(jpegs)),
        "rgb_one_thread_ms": host_ms(
            lambda: shim.decode_batch(jpegs, threads=1)),
        "pil_ms": host_ms(lambda: [codec._pil_decode(d) for d in jpegs], 3),
        "rgb_h2d_bytes": rgb_bytes,
    }
    for scale in (1, 2):
        packed, _ = shim.decode_ycbcr_batch(jpegs, scale=scale)
        timing[f"ycbcr_s{scale}_ms"] = host_ms(
            lambda: shim.decode_ycbcr_batch(jpegs, scale=scale))
        timing[f"ycbcr_s{scale}_h2d_bytes"] = packed.shape[0] * packed.shape[1]
    out["batch_decode"] = timing
    return out


def ycbcr_path(device, jpegs: list[bytes]) -> dict:
    """run_device_ycbcr_packed (RFB-320 bf16, frozen weights) on the
    packed planes of ``jpegs`` at scales 1 and 2, against run_device on
    the shim's RGB decode of the same bytes; then the float32 program on
    the card against the CPU at scale 1."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector, unpack_detections
    from infercam_onnx_tpu_torch.eval.parity import parity_report
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.ops.jpeg_device import (combine_ycbcr,
                                                         unpack_ycbcr_planes)

    shim = native_jpeg.load()
    det = Detector(weights=str(WEIGHTS), device=device)
    out = {"by_scale": {}}
    for scale in (1, 2):
        packed, geom = shim.decode_ycbcr_batch(jpegs, scale=scale)
        packed_dev = torch.from_numpy(np.array(packed)).to(device)
        frames = np.stack(shim.decode_batch(jpegs, scale=scale))
        frames_dev = torch.from_numpy(frames).to(device)

        def program():
            return det.run_device_ycbcr_packed(packed_dev, geom,
                                               pack_output=True)

        program()  # the first call's cuDNN choices and matrices
        det.run_device(frames_dev, pack_output=True)
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        fused = program()
        torch.cuda.synchronize()
        launches = nms.kernel.launches
        pixels = det.run_device(frames_dev, pack_output=True)
        report = parity_report(unpack_detections(fused.cpu().numpy()),
                               unpack_detections(pixels.cpu().numpy()),
                               iou_thresh=0.8, conf_tol=0.05)
        keys = {k: geom[k] for k in ("y_pw", "y_ph", "c_pw", "c_ph")}

        def tail():
            return combine_ycbcr(*unpack_ycbcr_planes(packed_dev, **keys),
                                 width=geom["width"], height=geom["height"],
                                 sampling=geom["sampling"])

        t0 = time.perf_counter()
        for _ in range(10):  # numpy planes in, packed detections on the host
            det.run_device_ycbcr_packed(packed, geom, pack_output=True).cpu()
        round_trip_ms = (time.perf_counter() - t0) / 10 * 1e3
        prof = profile_device(program, 20)
        tail_prof = profile_device(tail, 20)
        out["by_scale"][scale] = {
            "geom": geom, "h2d_bytes": packed.shape[0] * packed.shape[1],
            "launches": {"nms": launches},
            "sanity": check_packed(fused, det.config.min_confidence),
            "parity_vs_pixels": report.as_dict(),
            "ms_per_batch": time_ms(program, 20),
            "pixels_ms_per_batch": time_ms(
                lambda: det.run_device(frames_dev, pack_output=True), 20),
            "host_round_trip_ms": round_trip_ms,
            "device_busy_ms_per_batch": prof["device_ms"],
            "profiled_wall_ms_per_batch": prof["wall_ms"],
            "device_idle_share": prof["idle_share"],
            "device_ops_per_batch": prof["device_ops_per_iter"],
            "top_device_ms": prof["top"],
            "tail_ms": time_ms(tail, 20),
            "tail_device_ms": tail_prof["device_ms"],
            "tail_device_ops": tail_prof["device_ops_per_iter"],
            "tail_top_device_ms": tail_prof["top"],
        }

    packed, geom = shim.decode_ycbcr_batch(jpegs)
    config = DetectorConfig(compute_dtype="float32")
    got, want = (Detector(config, weights=str(WEIGHTS), device=d)
                 .run_device_ycbcr_packed(packed, geom, pack_output=True)
                 .cpu() for d in (device, "cpu"))
    out["float32_cuda_vs_cpu"] = {
        "counts_equal": bool(torch.equal(got[..., 5], want[..., 5])),
        "detections": int(want[..., 5].sum()),
        "max_box_diff": float((got[..., :4] - want[..., :4]).abs().max()),
        "max_conf_diff": float((got[..., 4] - want[..., 4]).abs().max())}
    return out


# -- phase 4c and 4d: the device annotate tail and the coefficients mode ---

SPLICE_K = 768  # EngineConfig.annotate_splice_blocks' default


def coefficient_agreement(got, want) -> dict:
    """Share of equal quantized coefficients and the largest difference."""
    import numpy as np

    got, want = (np.asarray(a).astype(np.int32) for a in (got, want))
    return {"n": int(got.size), "equal_share": float((got == want).mean()),
            "max_diff": int(np.abs(got - want).max(initial=0))}


def unpacked(coefs) -> "np.ndarray":
    """[B, m] pack12 rows (a tensor anywhere) -> [B, m*2//3] int16."""
    import numpy as np

    from infercam_onnx_tpu_torch.ops.jpeg_encode_device import unpack12

    return np.stack([unpack12(row) for row in coefs.cpu().numpy()])


def detections_agreement(got, want) -> dict:
    """Packed detections of the card against the CPU's."""
    import torch

    got, want = got.cpu(), want.cpu()
    return {"counts_equal": bool(torch.equal(got[..., 5], want[..., 5])),
            "detections": int(want[..., 5].sum()),
            "max_box_diff": float((got[..., :4] - want[..., :4]).abs().max()),
            "max_conf_diff": float((got[..., 4] - want[..., 4]).abs().max())}


def in_turns(fns: dict, iters: int = 20) -> dict:
    """ms per call of each of ``fns`` by CUDA events, in turns: a, b, b, a
    (each entry the two readings)."""
    names = list(fns)
    order = names + names[::-1]
    out = {n: [] for n in names}
    for n in order:
        out[n].append(time_ms(fns[n], iters))
    return out


def annotate_path(device, jpegs: list[bytes]) -> dict:
    """The two annotated programs of the device annotate tail (RFB-320
    bf16, frozen weights) on the 16 frames of ``jpegs``: pixels
    (run_device_annotated on the shim's RGB decode) and ycbcr
    (run_device_ycbcr_annotated on its packed planes, scale 1). Each
    frame's coefficients are entropy-coded (encode_coefs) and decoded
    again, against the host's draw + encode_rgb of the same detections;
    the packed detections against the detection-only program on the same
    batch; the float32 programs on the card against the CPU, and with
    TF32 on through either API; times in turns with the detection-only
    programs, the tail's device time, and the host's time a frame."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import (Detector, _encode_quant,
                                                  unpack_detections)
    from infercam_onnx_tpu_torch.draw import draw_detections
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.ops import jpeg_encode_device as enc
    from infercam_onnx_tpu_torch.ops.jpeg_device import unpack_ycbcr_planes

    shim = native_jpeg.load()
    quant = native_jpeg.quant_tables_cached(95)
    frames = np.stack(shim.decode_batch(jpegs))
    packed, geom = shim.decode_ycbcr_batch(jpegs)
    frames_dev = torch.from_numpy(frames).to(device)
    packed_dev = torch.from_numpy(np.array(packed)).to(device)
    planes = {"detect_annotate": lambda: enc.rgb_to_ycbcr_planes(
                  frames_dev, sampling=(2, 2)),
              "detect_annotate_from_ycbcr": lambda: unpack_ycbcr_planes(
                  packed_dev, **{k: geom[k] for k in ("y_pw", "y_ph", "c_pw",
                                                      "c_ph")})}
    geoms = {"detect_annotate": enc.plane_geometry(640, 480, (2, 2)),
             "detect_annotate_from_ycbcr": geom}

    def programs(det, frames_in, packed_in):
        return {"detect_annotate": (
                    lambda: det.run_device_annotated(frames_in),
                    lambda: det.run_device(frames_in, pack_output=True)),
                "detect_annotate_from_ycbcr": (
                    lambda: det.run_device_ycbcr_annotated(packed_in, geom),
                    lambda: det.run_device_ycbcr_packed(packed_in, geom,
                                                        pack_output=True))}

    det = Detector(weights=str(WEIGHTS), device=device)
    out = {"by_program": {}}
    for name, (annotated, detect_only) in programs(det, frames_dev,
                                                   packed_dev).items():
        annotated()  # the first call's cuDNN choices and matrices
        detect_only()
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        coefs, pdet = annotated()
        torch.cuda.synchronize()
        launches = nms.kernel.launches
        plain = detect_only()
        coefs_h, pdet_h = coefs.cpu().numpy(), pdet.cpu().numpy()
        g = geoms[name]
        dets = unpack_detections(pdet_h)
        jpeg = [shim.encode_coefs(*enc.split_coefs(coefs_h[i], g),
                                  (640, 480), g["sampling"], quant)
                for i in range(len(frames))]
        host = [codec.encode_rgb(draw_detections(f, d))
                for f, d in zip(frames, dets)]
        mad = [float(np.abs(codec.decode_rgb(a).astype(np.int32)
                            - codec.decode_rgb(b)).mean())
               for a, b in zip(jpeg, host)]
        tail_planes = planes[name]

        def tail(tail_planes=tail_planes, pdet=pdet):
            drawn = enc.render_overlay_ycbcr(*tail_planes(), pdet, width=640,
                                             height=480, sampling=(2, 2))
            return enc.encode_planes(*drawn, _encode_quant(95, device))

        tail_prof = profile_device(tail, 10)
        prof = profile_device(annotated, 10)
        turns = in_turns({"detect_only": detect_only, "annotated": annotated})
        out["by_program"][name] = {
            "launches": {"nms": launches},
            "sanity": check_packed(pdet, det.config.min_confidence),
            "detections_identical_to_detect_only": bool(torch.equal(pdet,
                                                                    plain)),
            "mad_vs_host_draw_encode": mad,
            "readback_bytes": coefs.nbytes + pdet.nbytes,
            "coefs_bytes_per_frame": coefs.shape[1],
            "ms_per_batch_in_turns": turns,
            "device_busy_ms_per_batch": prof["device_ms"],
            "profiled_wall_ms_per_batch": prof["wall_ms"],
            "device_idle_share": prof["idle_share"],
            "device_ops_per_batch": prof["device_ops_per_iter"],
            "top_device_ms": prof["top"],
            "tail_device_ms": tail_prof["device_ms"],
            "tail_device_ops": tail_prof["device_ops_per_iter"],
            "tail_top_device_ms": tail_prof["top"],
            "host_encode_coefs_ms_per_frame": host_ms(lambda: [
                shim.encode_coefs(*enc.split_coefs(coefs_h[i], g), (640, 480),
                                  g["sampling"], quant)
                for i in range(len(frames))]) / len(frames),
            "host_draw_encode_rgb_ms_per_frame": host_ms(lambda: [
                codec.encode_rgb(draw_detections(f, d))
                for f, d in zip(frames, dets)], 3) / len(frames),
        }

    # the label layer alone at the main path's widths: B=16, D=64 strips
    # on the luma plane and both 4:2:0 chroma planes (dense: its cost does
    # not depend on where the labels are)
    b, d = frames.shape[0], det.config.max_detections
    rng = np.random.default_rng(0)
    conf = torch.from_numpy(rng.uniform(0.5, 1.0, (b, d)).astype(
        np.float32)).to(device)
    strips = enc._label_strips(conf)
    xs, ys = (torch.from_numpy(rng.integers(0, hi, (b, d))).to(device)
              for hi in (640 - 70, 480 - 20))
    lum = torch.zeros(b, 480, 640, device=device)
    chroma = torch.zeros(b, 240, 320, device=device)
    cstrips = strips.reshape(b, d, 10, 2, 35, 2).mean(dim=(3, 5))

    def labels():
        enc._stamp_labels(lum, xs, ys, strips, enc.GREEN_Y)
        for value in (enc.GREEN_CB, enc.GREEN_CR):
            enc._stamp_labels(chroma, xs // 2, ys // 2, cstrips, value)

    lab = profile_device(labels, 10)
    out["label_layer_b16_d64"] = {"device_ms": lab["device_ms"],
                                  "device_ops": lab["device_ops_per_iter"],
                                  "top_device_ms": lab["top"]}

    # float32: the card against the CPU, and TF32 switched on
    config = DetectorConfig(compute_dtype="float32")
    f32 = {dev: programs(Detector(config, weights=str(WEIGHTS), device=dev),
                         frames, packed)
           for dev in (device, "cpu")}
    out["float32_cuda_vs_cpu"], out["float32_tf32_moved"] = {}, {}
    for name in programs(det, frames, packed):
        set_tf32("off")
        got = f32[device][name][0]()
        want = f32["cpu"][name][0]()
        out["float32_cuda_vs_cpu"][name] = {
            "coefficients": coefficient_agreement(unpacked(got[0]),
                                                  unpacked(want[0])),
            "detections": detections_agreement(got[1], want[1])}
        base = got[0].cpu()
        moved = {}
        for state in ("on_legacy_api", "on_fp32_precision_api"):
            set_tf32(state)
            moved[state] = not torch.equal(f32[device][name][0]()[0].cpu(),
                                           base)
        out["float32_tf32_moved"][name] = moved
    set_tf32("default")
    return out


def coefficients_path(device, jpegs: list[bytes]) -> dict:
    """The coefficients mode (RFB-320 bf16, frozen weights) on the 16
    frames of ``jpegs``: detect_from_coefficients
    (run_device_coefficients_arrays) and the splice transcode
    (run_device_coefficients_annotated_packed, k=768) on the host's
    entropy-decoded blocks. Box parity with run_device on the shim's RGB
    decode of the same bytes, every block the splice did not touch
    bit-exact, meta[0] <= k, float32 card against CPU, times in turns with
    the pixels program, and the host's entropy decode and packing."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import (Detector,
                                                  pack_coefficient_batch,
                                                  unpack_detections)
    from infercam_onnx_tpu_torch.eval.parity import parity_report
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch
    from infercam_onnx_tpu_torch.ops.jpeg_encode_device import splice_blocks

    y, cb, cr, quant, wh, samp = read_coefficient_batch(jpegs)
    packed12, _, shapes = pack_coefficient_batch(y, cb, cr, quant)
    frames = np.stack(native_jpeg.load().decode_batch(jpegs))

    def programs(det, to):
        arrays = [to(a) for a in (y, cb, cr, quant.astype(np.int32))]
        packed_in = to(packed12)
        return {"detect_from_coefficients": lambda: (
                    det.run_device_coefficients_arrays(
                        *arrays, wh, sampling=samp, pack_output=True)),
                "detect_annotate_splice": lambda: (
                    det.run_device_coefficients_annotated_packed(
                        packed_in, arrays[3], wh=wh, shapes=shapes,
                        sampling=samp, k=SPLICE_K))}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    det = Detector(weights=str(WEIGHTS), device=device)
    frames_dev = on_card(frames)
    progs = programs(det, on_card)
    out = {"geometry": {"wh": wh, "sampling": samp, "y_blocks": y.shape[1:3],
                        "c_blocks": cb.shape[1:3]},
           "upload_bytes": {"detect_from_coefficients": int(
                                y.nbytes + cb.nbytes + cr.nbytes
                                + quant.size * 4),
                            "detect_annotate_splice": int(
                                packed12.nbytes + quant.size * 4)},
           "host_read_coefficient_batch_ms": host_ms(
               lambda: read_coefficient_batch(jpegs)),
           "host_pack_coefficient_batch_ms": host_ms(
               lambda: pack_coefficient_batch(y, cb, cr, quant)),
           "by_program": {}}
    for name, fn in progs.items():
        fn()
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        res = fn()
        torch.cuda.synchronize()
        rec = {"launches": {"nms": nms.kernel.launches}}
        pdet = res if name == "detect_from_coefficients" else res[2]
        rec["sanity"] = check_packed(pdet, det.config.min_confidence)
        rec["readback_bytes"] = sum(
            t.nbytes for t in (res if isinstance(res, tuple) else (res,)))
        prof = profile_device(fn, 10)
        rec.update({"device_busy_ms_per_batch": prof["device_ms"],
                    "profiled_wall_ms_per_batch": prof["wall_ms"],
                    "device_idle_share": prof["idle_share"],
                    "device_ops_per_batch": prof["device_ops_per_iter"],
                    "top_device_ms": prof["top"]})
        out["by_program"][name] = rec
    fused = progs["detect_from_coefficients"]()
    pixels = det.run_device(frames_dev, pack_output=True)
    out["by_program"]["detect_from_coefficients"]["parity_vs_pixels"] = (
        parity_report(unpack_detections(fused.cpu().numpy()),
                      unpack_detections(pixels.cpu().numpy()),
                      iou_thresh=0.8, conf_tol=0.05).as_dict())
    blocks, meta, _ = (t.cpu().numpy()
                       for t in progs["detect_annotate_splice"]())
    untouched_equal, touched, selected = [], [], []
    for i in range(len(jpegs)):
        spliced = splice_blocks(y[i], cb[i], cr[i], meta[i], blocks[i])
        flat = [np.concatenate([p.reshape(-1, 64) for p in ps])
                for ps in ((y[i], cb[i], cr[i]), spliced)]
        keep = np.ones(len(flat[0]), bool)
        keep[meta[i, 1:][meta[i, 1:] >= 0]] = False
        untouched_equal.append(bool(np.array_equal(flat[0][keep],
                                                   flat[1][keep])))
        touched.append(int(meta[i, 0]))
        selected.append(int((meta[i, 1:] >= 0).sum()))
    out["by_program"]["detect_annotate_splice"].update({
        "k": SPLICE_K, "touched_blocks": touched, "selected_blocks": selected,
        "overflowed_frames": sum(t > SPLICE_K for t in touched),
        "blocks_total": int(flat[0].shape[0]),
        "untouched_bit_exact": untouched_equal})
    out["ms_per_batch_in_turns"] = in_turns({
        "pixels": lambda: det.run_device(frames_dev, pack_output=True),
        **progs})

    config = DetectorConfig(compute_dtype="float32")
    f32 = {dev: programs(Detector(config, weights=str(WEIGHTS), device=dev),
                         on_card if dev != "cpu" else torch.from_numpy)
           for dev in (device, "cpu")}
    got = {n: fn() for n, fn in f32[device].items()}
    want = {n: fn() for n, fn in f32["cpu"].items()}
    out["float32_cuda_vs_cpu"] = {
        "detect_from_coefficients": {"detections": detections_agreement(
            got["detect_from_coefficients"],
            want["detect_from_coefficients"])},
        "detect_annotate_splice": {
            "detections": detections_agreement(
                got["detect_annotate_splice"][2],
                want["detect_annotate_splice"][2]),
            "meta_equal": bool(torch.equal(got["detect_annotate_splice"][1]
                                           .cpu(),
                                           want["detect_annotate_splice"][1])),
            "coefficients": coefficient_agreement(
                unpacked(got["detect_annotate_splice"][0]),
                unpacked(want["detect_annotate_splice"][0]))}}
    return out


def check_annotate(rec: dict) -> None:
    """The annotate and coefficients phases' failure conditions for one
    program's record."""
    if rec["launches"]["nms"] != 1:
        raise SystemExit(f"a program launched the nms kernel "
                         f"{rec['launches']['nms']} times, not once")
    if not rec["sanity"]["ok"]:
        raise SystemExit("a program's detections failed their sanity checks")


def check_card_vs_cpu(agreement: dict, what: str) -> None:
    """Coefficients: >= 99.9% equal and never more than 1 apart;
    detections: counts equal, boxes within 1e-5, confidences within 5e-5."""
    c = agreement.get("coefficients")
    if c and (c["equal_share"] < 0.999 or c["max_diff"] > 1):
        raise SystemExit(f"{what}: float32 coefficients on the card differ "
                         f"from the CPU's: {c}")
    d = agreement["detections"]
    if (not d["counts_equal"] or d["max_box_diff"] > 1e-5
            or d["max_conf_diff"] > 5e-5):
        raise SystemExit(f"{what}: float32 detections on the card differ "
                         f"from the CPU's: {d}")


# -- phase 4e and 4f: tiled high-resolution detection and the link probe ---

HD = (1920, 1080)
TILE_GRID, TILE_OVERLAP = (2, 2), 0.2


def hd_jpegs(n: int) -> list[bytes]:
    """n 1920x1080 quality-90 4:2:0 JPEGs of the synthetic pictures, plain
    and mirrored, upscaled with PIL's bilinear filter (bench.py's
    _hd_frames does the same with the photo corpus)."""
    import io

    from PIL import Image

    pics = [Image.open(p).convert("RGB")
            for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    out = []
    for i in range(n):
        im = pics[i % len(pics)]
        if (i // len(pics)) % 2:
            im = im.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
        buf = io.BytesIO()
        im.resize(HD, Image.BILINEAR).save(buf, "JPEG", quality=90,
                                           subsampling="4:2:0")
        out.append(buf.getvalue())
    return out


def tiled_agreement(got, want) -> dict:
    """The JAX package's bar for the tiled ycbcr against the tiled pixels
    program (tests/test_parallel.py:131-144), per frame: counts within 2,
    and each of the top three quarters of ``got``'s boxes within 5e-3 of a
    distinct box of ``want`` (nearest first; near-tie confidences may
    reorder rows)."""
    import numpy as np

    got, want = got.cpu().numpy(), want.cpu().numpy()
    count_diff, worst = [], 0.0
    for g, w in zip(got, want):
        n_got, n_want = int(g[:, 5].sum()), int(w[:, 5].sum())
        count_diff.append(n_got - n_want)
        remaining = [w[j, :4] for j in range(n_want)]
        for i in range(min(n_got, n_want) * 3 // 4):
            dists = [float(np.abs(g[i, :4] - r).max()) for r in remaining]
            j = int(np.argmin(dists))
            worst = max(worst, dists[j])
            remaining.pop(j)
    return {"count_diff": count_diff, "worst_top_box_diff": worst,
            "ok": max(map(abs, count_diff)) <= 2 and worst < 5e-3}


def tiled_path(device, jpegs: list[bytes]) -> dict:
    """TiledDetector (2x2, overlap 0.2; RFB-320 bf16, frozen weights) on
    the 1080p ``jpegs`` at decode scales 1 and 2, through its three entry
    points, against the plain scan, the 1x1 grid, the pixels program and
    (float32, scale 1) the CPU; times in turns with the untiled program."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector, unpack_detections
    from infercam_onnx_tpu_torch.eval.parity import parity_report
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.parallel import tiling

    shim = native_jpeg.load()
    det = Detector(weights=str(WEIGHTS), device=device)
    out = {"grid": TILE_GRID, "overlap": TILE_OVERLAP, "frames": len(jpegs),
           "jpeg_bytes_per_frame": sum(map(len, jpegs)) / len(jpegs),
           "by_scale": {}}
    for scale in (1, 2):
        frames = np.stack(shim.decode_batch(jpegs, scale=scale))
        packed, geom = shim.decode_ycbcr_batch(jpegs, scale=scale)
        w, h = geom["width"], geom["height"]
        frames_dev = torch.from_numpy(frames).to(device)
        packed_dev = torch.from_numpy(np.array(packed)).to(device)
        rows = [torch.from_numpy(np.array(r)).to(device) for r in packed]
        tiled = tiling.TiledDetector(det, (w, h), grid=TILE_GRID,
                                     overlap=TILE_OVERLAP)
        entries = {
            "tiled_detect_program": lambda: tiled.run_device(
                frames_dev, pack_output=True),
            "tiled_detect_from_ycbcr": (
                lambda: tiled.run_device_ycbcr_packed(packed_dev, geom,
                                                      pack_output=True)),
            "tiled_detect_from_ycbcr_rows": (
                lambda: tiled.run_device_ycbcr_rows(rows, geom,
                                                    pack_output=True))}
        launches, outs = {}, {}
        for name, call in entries.items():
            call()  # the first call's cuDNN choices
            torch.cuda.synchronize()
            nms.kernel.launches = 0
            outs[name] = call()
            torch.cuda.synchronize()
            launches[name] = nms.kernel.launches
        kw = dict(tiles=tiled.tiles, pack_output=True, nms_impl="scan",
                  **det._thresholds())
        scan_pixels = tiling.tiled_detect_program(
            det.model, det.priors, frames_dev, tiled._r_h, tiled._r_w, **kw)
        scan_ycbcr = tiling.tiled_detect_from_ycbcr_program(
            det.model, det.priors, packed_dev, tiled._r_h, tiled._r_w,
            geom_key=tiling.geometry_key(geom), **kw)
        pixels = outs["tiled_detect_program"]
        ycbcr = outs["tiled_detect_from_ycbcr"]
        one = tiling.TiledDetector(det, (w, h), grid=(1, 1)).run_device(
            frames_dev, pack_output=True)
        untiled = det.run_device(frames_dev, pack_output=True)
        prof = profile_device(entries["tiled_detect_program"], 10)
        prof_y = profile_device(entries["tiled_detect_from_ycbcr"], 10)
        out["by_scale"][scale] = {
            "frame": [w, h], "tiles": tiled.tiles,
            "tile_size": [tiled.tiles[0][2] - tiled.tiles[0][0],
                          tiled.tiles[0][3] - tiled.tiles[0][1]],
            "launches": launches,
            "sanity": {n: check_packed(o, det.config.min_confidence)
                       for n, o in outs.items()},
            "kernel_equals_scan": {
                "tiled_detect_program": bool(torch.equal(pixels,
                                                         scan_pixels)),
                "tiled_detect_from_ycbcr": bool(torch.equal(ycbcr,
                                                            scan_ycbcr))},
            "rows_equal_packed": bool(torch.equal(
                outs["tiled_detect_from_ycbcr_rows"], ycbcr)),
            "grid_1x1_vs_untiled": {
                "identical": bool(torch.equal(one, untiled)),
                "counts_equal": bool(torch.equal(one[..., 5],
                                                 untiled[..., 5])),
                "max_box_diff": float((one[..., :4] - untiled[..., :4])
                                      .abs().max())},
            "ycbcr_vs_pixels": tiled_agreement(ycbcr, pixels),
            "ycbcr_parity_vs_pixels": parity_report(
                unpack_detections(ycbcr.cpu().numpy()),
                unpack_detections(pixels.cpu().numpy()),
                iou_thresh=0.8, conf_tol=0.05).as_dict(),
            "detections_tiled_vs_untiled": [int(pixels[..., 5].sum()),
                                            int(untiled[..., 5].sum())],
            "ms_per_batch_in_turns": in_turns({
                "untiled_detect_program": lambda: det.run_device(
                    frames_dev, pack_output=True), **entries}, 10),
            "device_busy_ms_per_batch": prof["device_ms"],
            "profiled_wall_ms_per_batch": prof["wall_ms"],
            "device_idle_share": prof["idle_share"],
            "device_ops_per_batch": prof["device_ops_per_iter"],
            "top_device_ms": prof["top"],
            "ycbcr_device_busy_ms_per_batch": prof_y["device_ms"],
            "ycbcr_device_ops_per_batch": prof_y["device_ops_per_iter"],
            "upload_bytes": {"pixels": int(frames.nbytes),
                             "stacked": int(packed.nbytes),
                             "rows": [len(packed), int(packed[0].nbytes)]},
        }

    # float32 on the card: the JAX package's tiled bar, ycbcr against
    # pixels at scale 1 (tests/test_parallel.py holds it on a float32
    # detector at full decode), over all the frames; then against the CPU
    # on 2 frames at 1920x1080
    config = DetectorConfig(compute_dtype="float32")
    f32 = {dev: tiling.TiledDetector(
        Detector(config, weights=str(WEIGHTS), device=dev), HD,
        grid=TILE_GRID, overlap=TILE_OVERLAP) for dev in (device, "cpu")}
    packed, geom = shim.decode_ycbcr_batch(jpegs)
    out["float32_ycbcr_vs_pixels"] = tiled_agreement(
        f32[device].run_device_ycbcr_packed(packed, geom, pack_output=True),
        f32[device].run_device(np.stack(shim.decode_batch(jpegs)),
                               pack_output=True))
    frames = np.stack(shim.decode_batch(jpegs[:2]))
    set_tf32("off")
    got = f32[device].run_device(frames, pack_output=True).cpu()
    want = f32["cpu"].run_device(frames, pack_output=True)
    set_tf32("on_fp32_precision_api")
    tf32 = f32[device].run_device(frames, pack_output=True).cpu()
    set_tf32("default")
    out["float32_cuda_vs_cpu"] = {
        "detections": detections_agreement(got, want),
        "moved_by_tf32": not torch.equal(tf32, got)}
    return out


def link_probe(device) -> dict:
    """serving/link.py's probes on the card, three readings each, and the
    decision tables they give (the thresholds are the JAX package's, for
    its TPU host link)."""
    from infercam_onnx_tpu_torch.config import EngineConfig
    from infercam_onnx_tpu_torch.serving import link

    mbps = [link.probe_h2d_mbps(device=device) for _ in range(3)]
    ab = [link.probe_tiled_route_ms(device=device) for _ in range(3)]
    # a batch of 16 1080p frames' packed 4:2:0 planes at decode scale 1
    ab16 = [link.probe_tiled_route_ms(frames=16,
                                      mb_per_frame=3_133_440 / 2 ** 20,
                                      device=device) for _ in range(3)]
    coef = EngineConfig(decode_mode="coefficients", annotate_mode="device",
                        tile_min_pixels=921_600)
    return {"h2d_mbps_4mb": mbps,
            "tiled_route_ms_b4_0.78mb": ab,
            "tiled_route_ms_b16_1080p": ab16,
            "decisions": {
                "default": link.decide(EngineConfig(), mbps[0]),
                "coefficients_device_annotate": link.decide(
                    coef, mbps[0], tiled_ab_ms=ab[0])}}


# -- phase 4g: data-parallel replicas ----------------------------------------


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def outputs_equal(got, want) -> bool:
    got, want = _outputs(got), _outputs(want)
    import torch

    return len(got) == len(want) and all(torch.equal(g, w)
                                         for g, w in zip(got, want))


def concat_outputs(parts: list):
    """Per-output concatenation of several calls' outputs."""
    import torch

    cols = [torch.cat(c) for c in zip(*(_outputs(p) for p in parts))]
    return cols[0] if len(cols) == 1 else tuple(cols)


def within_c3(agreement: dict) -> bool:
    """ROADMAP C.3: counts equal, boxes within 1e-5, confidences 5e-5."""
    return (agreement["counts_equal"] and agreement["max_box_diff"] <= 1e-5
            and agreement["max_conf_diff"] <= 5e-5)


def host_call_ms(fn, reps: int = 20) -> float:
    """Median host ms the calling thread spends in ``fn()`` (the enqueue
    of its launches), the card idle before each call."""
    import statistics

    import torch

    fn()
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples)


def replica_programs(device, jpegs: list[bytes]) -> dict:
    """Every program of Detector as ``prog(detector, rows)`` on
    device-resident inputs made from ``jpegs`` (rows: a slice of the
    batch)."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.detector import pack_coefficient_batch
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch

    shim = native_jpeg.load()

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    frames = on_card(np.stack(shim.decode_batch(jpegs)))
    packed, geom = shim.decode_ycbcr_batch(jpegs)
    packed = on_card(packed)
    y, cb, cr, quant, wh, samp = read_coefficient_batch(jpegs)
    packed12, _, shapes = pack_coefficient_batch(y, cb, cr, quant)
    y, cb, cr, quant, packed12 = (on_card(a) for a in (
        y, cb, cr, quant.astype(np.int32), packed12))
    return {
        "detect_program": lambda d, r: d.run_device(frames[r],
                                                    pack_output=True),
        "detect_program_tuple": lambda d, r: d.run_device(frames[r]),
        "detect_from_ycbcr": lambda d, r: d.run_device_ycbcr_packed(
            packed[r], geom, pack_output=True),
        "detect_from_coefficients": (
            lambda d, r: d.run_device_coefficients_arrays(
                y[r], cb[r], cr[r], quant[r], wh, sampling=samp,
                pack_output=True)),
        "detect_annotate": lambda d, r: d.run_device_annotated(frames[r]),
        "detect_annotate_from_ycbcr": (
            lambda d, r: d.run_device_ycbcr_annotated(packed[r], geom)),
        "detect_annotate_splice": (
            lambda d, r: d.run_device_coefficients_annotated_packed(
                packed12[r], quant[r], wh=wh, shapes=shapes, sampling=samp,
                k=SPLICE_K)),
    }


def sharded_path(device, jpegs: list[bytes], hd: list[bytes]) -> dict:
    """ShardedDetector (RFB-320 bf16, frozen weights) over [device] and
    over [device, device] (two replicas, four streams, one card) on every
    program: one replica bit-identical to Detector; two replicas
    bit-identical to Detector on each shard's 8 rows, concatenated
    (a batch of 16 may choose other cuDNN algorithms than 8), and in
    float32 within C.3 of the 16-row call; NMS launches a call. The tiled
    mesh modes on the 1080p ``hd`` frames: batch_sharded_out bit-identical
    to the plain TiledDetector on each shard's 8 frames, the default mode
    (the 64 tiles split 32 a replica) in float32 within C.3 of the plain
    TiledDetector. ms a batch in turns and host ms a call."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.parallel import (ShardedDetector,
                                                  TiledDetector)

    rows, halves = slice(None), (slice(0, 8), slice(8, 16))
    progs = replica_programs(device, jpegs)
    out = {"batch": len(jpegs), "frame": [640, 480], "by_program": {}}

    def launches_of(call):
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        result = call()
        torch.cuda.synchronize()
        return result, nms.kernel.launches

    for dtype in ("bfloat16", "float32"):
        det = Detector(DetectorConfig(compute_dtype=dtype),
                       weights=str(WEIGHTS), device=device)
        one = ShardedDetector(det, [device])
        two = ShardedDetector(det, [device, device])
        for name, prog in progs.items():
            for r in (rows, halves[0]):  # the cuDNN choices at 16 and 8
                prog(det, r)
            plain = prog(det, rows)
            got_one, l_one = launches_of(lambda: prog(one, rows))
            got_two, l_two = launches_of(lambda: prog(two, rows))
            want_two = concat_outputs([prog(det, h) for h in halves])
            rec = out["by_program"].setdefault(name, {})
            rec[dtype] = {
                "launches_one_replica": l_one,
                "launches_two_replicas": l_two,
                "one_replica_identical": outputs_equal(got_one, plain),
                "two_replicas_identical_per_shard": outputs_equal(got_two,
                                                                  want_two),
                "two_replicas_vs_b16": detections_agreement(
                    _packed(got_two, name), _packed(plain, name)),
            }
        if dtype == "bfloat16":
            frames_dev = torch.from_numpy(np.stack(
                native_jpeg.load().decode_batch(jpegs))).to(device)
            calls = {"plain_b16": lambda: det.run_device(frames_dev,
                                                         pack_output=True),
                     "sharded_1x16": lambda: one.run_device(
                         frames_dev, pack_output=True),
                     "sharded_2x8": lambda: two.run_device(
                         frames_dev, pack_output=True)}
            out["ms_per_batch_in_turns"] = in_turns(calls)
            out["host_ms_per_call"] = {n: host_call_ms(c)
                                       for n, c in calls.items()}
            out["tiled"] = tiled_mesh_modes(det, two, hd)
        else:
            out["tiled"]["float32_split_tiles_vs_plain"] = (
                tiled_mesh_modes(det, two, hd, float32=True))
    return out


def _packed(out, name: str):
    """The packed detections of a program's outputs (the tuple form
    packed)."""
    from infercam_onnx_tpu_torch.detector import pack_detections

    if name == "detect_program_tuple":
        return pack_detections(*out)
    return _outputs(out)[-1]


def tiled_mesh_modes(det, two, hd: list[bytes], *,
                     float32: bool = False) -> dict:
    """The two tiled mesh modes over ``two``'s replicas on the 16 1080p
    frames (pixels and packed planes): NMS launches a call, the
    batch-sharded mode against the plain TiledDetector per shard, times
    in turns. ``float32``: the default mode against the plain
    TiledDetector on all 16 frames."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.parallel import TiledDetector

    shim = native_jpeg.load()
    device = det.device
    frames = torch.from_numpy(np.stack(shim.decode_batch(hd))).to(device)
    packed, geom = shim.decode_ycbcr_batch(hd)
    packed = torch.from_numpy(np.array(packed)).to(device)
    kw = dict(grid=TILE_GRID, overlap=TILE_OVERLAP)
    plain = TiledDetector(det, HD, **kw)
    split = TiledDetector(two, HD, mesh=two.mesh, **kw)
    if float32:
        agreement = {}
        for name, call in (("pixels", lambda t: t.run_device(
                frames, pack_output=True)), ("ycbcr", lambda t: (
                t.run_device_ycbcr_packed(packed, geom, pack_output=True)))):
            agreement[name] = detections_agreement(call(split), call(plain))
        return agreement
    sharded_out = TiledDetector(two, HD, mesh=two.mesh,
                                batch_sharded_out=True, **kw)
    entries = {
        "pixels": lambda t, r=slice(None): t.run_device(frames[r],
                                                        pack_output=True),
        "ycbcr": lambda t, r=slice(None): t.run_device_ycbcr_packed(
            packed[r], geom, pack_output=True)}
    out = {"frames": len(hd), "tiles_per_call": len(hd) * len(plain.tiles),
           "by_input": {}}
    for name, call in entries.items():
        for t in (plain, split, sharded_out):
            call(t)  # the cuDNN choices
        call(plain, slice(0, 8))
        launches = {}
        for mode, t in (("split_tiles", split),
                        ("batch_sharded_out", sharded_out)):
            torch.cuda.synchronize()
            nms.kernel.launches = 0
            got = call(t)
            torch.cuda.synchronize()
            launches[mode] = nms.kernel.launches
            if mode == "batch_sharded_out":
                want = torch.cat([call(plain, slice(0, 8)),
                                  call(plain, slice(8, 16))])
                identical = bool(torch.equal(got, want))
            else:
                split_vs_plain = detections_agreement(got, call(plain))
        out["by_input"][name] = {
            "launches": launches,
            "batch_sharded_out_identical_per_shard": identical,
            "split_tiles_vs_plain_bf16": split_vs_plain,
            "ms_per_batch_in_turns": in_turns({
                "plain_b16": lambda: call(plain),
                "split_tiles": lambda: call(split),
                "batch_sharded_out_2x8": lambda: call(sharded_out)}, 10)}
    return out


# -- phase 5: the serving tier ----------------------------------------------

# -- phase 4h: the ONNX graph runtime ---------------------------------------

GRAPH_ONNX = REPO / "tests" / "fixtures" / "ultraface_twin_rfb320.onnx"
# GraphDetector's programs beside Detector's (replica_programs' names)
GRAPH_TAILS = ("detect_from_ycbcr", "detect_annotate",
               "detect_annotate_from_ycbcr", "detect_from_coefficients")


def within(agreement: dict, tol: float) -> bool:
    """Counts equal, boxes and confidences within ``tol``."""
    return (agreement["counts_equal"] and agreement["max_box_diff"] <= tol
            and agreement["max_conf_diff"] <= tol)


QDQ_ONNX = REPO / "tests" / "fixtures" / "ultraface_twin_rfb320_qdq.onnx"
# Two runs of one int8 QDQ graph whose float32 sums run in other orders
# (the card and the CPU; the port and the JAX package) quantize an
# activation that sits on a rounding tie one step apart now and then, and
# the step travels on through the graph: matched boxes within 2e-3 (the
# JAX package's own bar against fbgemm), confidences within two steps of
# the score's quantization (0.012), and a detection only one side has
# within 0.05 of the confidence threshold, on at most a quarter of them.
QDQ_BOX_TOL, QDQ_CONF_TOL, QDQ_NEAR_THRESHOLD = 2e-3, 0.025, 0.05


def qdq_agreement(got, want, min_confidence: float) -> dict:
    """Packed detections of two runs of an int8 QDQ graph, matched per
    frame by IoU >= 0.5: the matched pairs' largest box and confidence
    differences, the confidences of the detections only one side has,
    and whether they hold the bar above (``ok``)."""
    import numpy as np

    from infercam_onnx_tpu_torch.detector import unpack_detections
    from infercam_onnx_tpu_torch.eval.parity import match_detections

    got, want = (unpack_detections(np.asarray(p.cpu() if hasattr(p, "cpu")
                                              else p)) for p in (got, want))
    box = conf = 0.0
    alone, total = [], 0
    for g, w in zip(got, want):
        total += max(len(g), len(w))
        pairs = match_detections(g, w)
        for i, j, _ in pairs:
            box = max(box, float(np.abs(np.asarray(g[i][0])
                                        - np.asarray(w[j][0])).max()))
            conf = max(conf, abs(g[i][1] - w[j][1]))
        alone += [g[i][1] for i in set(range(len(g))) - {p[0] for p in pairs}]
        alone += [w[j][1] for j in set(range(len(w))) - {p[1] for p in pairs}]
    return {"detections": total, "matched": total - len(alone),
            "max_box_diff": box, "max_conf_diff": conf,
            "unmatched_confidences": sorted(alone),
            "ok": bool(total and box <= QDQ_BOX_TOL and conf <= QDQ_CONF_TOL
                       and len(alone) <= 0.25 * total
                       and all(c < min_confidence + QDQ_NEAR_THRESHOLD
                               for c in alone))}


def graph_path(device, jpegs: list[bytes]) -> dict:
    """GraphDetector on the committed export of the frozen twin
    (tests/fixtures/ultraface_twin_rfb320.onnx, float32) on the 16 frames
    of 4b (the shim's RGB decode of ``jpegs``, on the card): run_device
    with one NMS launch a call and its packed output bit-identical to the
    same program with the plain scan; within 1e-4 of the native float32
    Detector on the frozen weights; the goldens gate; card against CPU on
    2 frames by C.3, unmoved with TF32 on process-wide; the four device
    tail programs one NMS launch each and within 1e-4 of the native
    detector's same program; to_mesh([device, device]) bit-identical per
    8-row shard with two launches a call; ms a batch in turns with the
    native detector, host ms a call of each, the profiler's device time
    and ops a call, and the graph's nodes a call."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector, detect_program
    from infercam_onnx_tpu_torch.eval.goldens import check_against_goldens
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms

    cfg = DetectorConfig(variant="RFB-320", compute_dtype="float32")
    graph = GraphDetector(str(GRAPH_ONNX), cfg, device=device)
    native = Detector(cfg, weights=str(WEIGHTS), device=device)
    frames_np = np.stack(native_jpeg.load().decode_batch(jpegs))
    frames = torch.from_numpy(frames_np).to(device)
    b, h, w, _ = frames.shape
    graph.warmup(b, h, w, pack_output=True)
    native.warmup(b, h, w, pack_output=True)
    out = {"onnx": str(GRAPH_ONNX.relative_to(REPO)), "batch": b,
           "frame": [w, h], "dtype": "float32",
           "graph_nodes": len(graph.graph.nodes),
           "graph_nodes_a_call": graph.executor.nodes_run}

    def launches_of(call):
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        result = call()
        torch.cuda.synchronize()
        return result, nms.kernel.launches

    packed, out["launches"] = launches_of(
        lambda: graph.run_device(frames, pack_output=True))
    out["host_copies_a_call"] = graph.executor.host_copies
    out["sanity"] = check_packed(packed, cfg.min_confidence)
    r_h, r_w = graph.preprocessor.matrices(w, h)
    plain = detect_program(graph.model, graph.priors, frames, r_h, r_w,
                           pack_output=True, nms_impl="scan",
                           **graph._thresholds())
    out["identical_kernel_vs_plain"] = bool(torch.equal(plain, packed))
    want = native.run_device(frames, pack_output=True)
    out["vs_native_float32"] = detections_agreement(packed, want)

    gold_cfg = DetectorConfig(variant="RFB-320", compute_dtype="float32",
                              top_k=512, max_detections=256)
    out["goldens"] = check_against_goldens(
        GraphDetector(str(GRAPH_ONNX), gold_cfg, device=device),
        str(SYNTH_PICS), str(GOLDENS))

    cpu = GraphDetector(str(GRAPH_ONNX), cfg, device="cpu")
    on_card = graph.run_device(frames[:2], pack_output=True).cpu()
    out["float32_cuda_vs_cpu"] = detections_agreement(
        on_card, cpu.run_device(frames_np[:2], pack_output=True))
    out["identical_with_tf32_on"] = {}
    for state in ("on_legacy_api", "on_fp32_precision_api"):
        set_tf32(state)
        out["identical_with_tf32_on"][state] = torch.equal(
            graph.run_device(frames[:2], pack_output=True).cpu(), on_card)
    set_tf32("default")

    progs = replica_programs(device, jpegs)
    rows = slice(None)
    out["by_program"] = {}
    for name in GRAPH_TAILS:
        got, launches = launches_of(lambda: progs[name](graph, rows))
        out["by_program"][name] = {
            "launches": launches,
            "vs_native_float32": detections_agreement(
                _packed(got, name), _packed(progs[name](native, rows),
                                            name))}

    two = graph.to_mesh([device, device])
    got_two, out["launches_two_replicas"] = launches_of(
        lambda: two.run_device(frames, pack_output=True))
    out["two_replicas_identical_per_shard"] = outputs_equal(
        got_two, concat_outputs([graph.run_device(frames[r],
                                                  pack_output=True)
                                 for r in (slice(0, 8), slice(8, 16))]))

    calls = {"graph": lambda: graph.run_device(frames, pack_output=True),
             "native_float32": lambda: native.run_device(frames,
                                                         pack_output=True)}
    out["ms_per_batch_in_turns"] = in_turns(calls)
    out["host_ms_per_call"] = {n: host_call_ms(c) for n, c in calls.items()}
    for n, c in calls.items():
        prof = profile_device(c, 10)
        out.setdefault("profile", {})[n] = {
            "device_busy_ms_per_batch": prof["device_ms"],
            "profiled_wall_ms_per_batch": prof["wall_ms"],
            "device_idle_share": prof["idle_share"],
            "device_ops_per_batch": prof["device_ops_per_iter"],
            "top_device_ms": prof["top"][:5]}
    return out


def check_graph(rec: dict) -> None:
    """The graph phase's failure conditions."""
    if rec["launches"] != 1 or not rec["sanity"]["ok"]:
        raise SystemExit(f"graph run_device: {rec['launches']} nms launches "
                         f"(not 1) or failed sanity {rec['sanity']}")
    if not rec["identical_kernel_vs_plain"]:
        raise SystemExit("graph run_device: kernel and plain NMS differ")
    if not within(rec["vs_native_float32"], 1e-4):
        raise SystemExit(f"graph run_device is not within 1e-4 of the native "
                         f"float32 detector: {rec['vs_native_float32']}")
    if not rec["goldens"]["passed"]:
        raise SystemExit("the goldens gate failed through GraphDetector")
    if not within_c3(rec["float32_cuda_vs_cpu"]):
        raise SystemExit(f"graph run_device: float32 on the card differs "
                         f"from the CPU's: {rec['float32_cuda_vs_cpu']}")
    if not all(rec["identical_with_tf32_on"].values()):
        raise SystemExit("the graph detector's output moved with the "
                         "process-wide TF32 setting")
    for name, r in rec["by_program"].items():
        if r["launches"] != 1:
            raise SystemExit(f"graph {name}: {r['launches']} nms launches")
        if not within(r["vs_native_float32"], 1e-4):
            raise SystemExit(f"graph {name} is not within 1e-4 of the "
                             f"native detector: {r['vs_native_float32']}")
    if rec["launches_two_replicas"] != 2 or not rec[
            "two_replicas_identical_per_shard"]:
        raise SystemExit("graph to_mesh over two replicas: "
                         f"{rec['launches_two_replicas']} launches, "
                         f"identical per shard "
                         f"{rec['two_replicas_identical_per_shard']}")


def qdq_path(device, jpegs: list[bytes]) -> dict:
    """GraphDetector on the committed int8 QDQ export of the frozen twin
    (tests/fixtures/ultraface_twin_rfb320_qdq.onnx, float32) on the 16
    frames of 4b: run_device with one NMS launch a call and its packed
    output bit-identical to the plain scan's; its four tail programs one
    launch each; to_mesh([device, device]) bit-identical per 8-row shard
    with two launches a call; card against CPU on 2 frames by
    `qdq_agreement` (the CPU tests' bar); box parity against the float
    GraphDetector printed; the nodes a call and how many are Q/DQ, host
    copies a call; ms a batch in turns with the float GraphDetector, host
    ms a call of each, the profiler's device time and ops a call."""
    import collections

    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import (detect_program,
                                                  unpack_detections)
    from infercam_onnx_tpu_torch.eval.parity import parity_report
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import nms

    cfg = DetectorConfig(variant="RFB-320", compute_dtype="float32")
    qdq = GraphDetector(str(QDQ_ONNX), cfg, device=device)
    graph = GraphDetector(str(GRAPH_ONNX), cfg, device=device)
    frames_np = np.stack(native_jpeg.load().decode_batch(jpegs))
    frames = torch.from_numpy(frames_np).to(device)
    b, h, w, _ = frames.shape
    qdq.warmup(b, h, w, pack_output=True)
    graph.warmup(b, h, w, pack_output=True)
    ops = collections.Counter(n.op_type for n in qdq.executor._nodes)
    out = {"onnx": str(QDQ_ONNX.relative_to(REPO)), "batch": b,
           "frame": [w, h], "dtype": "float32",
           "graph_nodes": len(qdq.graph.nodes),
           "graph_nodes_a_call": qdq.executor.nodes_run,
           "qdq_nodes_a_call": ops["QuantizeLinear"]
           + ops["DequantizeLinear"],
           "float_graph_nodes_a_call": graph.executor.nodes_run}

    def launches_of(call):
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        result = call()
        torch.cuda.synchronize()
        return result, nms.kernel.launches

    packed, out["launches"] = launches_of(
        lambda: qdq.run_device(frames, pack_output=True))
    out["host_copies_a_call"] = qdq.executor.host_copies
    out["sanity"] = check_packed(packed, cfg.min_confidence)
    r_h, r_w = qdq.preprocessor.matrices(w, h)
    plain = detect_program(qdq.model, qdq.priors, frames, r_h, r_w,
                           pack_output=True, nms_impl="scan",
                           **qdq._thresholds())
    out["identical_kernel_vs_plain"] = bool(torch.equal(plain, packed))
    floats = graph.run_device(frames, pack_output=True)
    out["parity_vs_float_graph"] = parity_report(
        unpack_detections(packed.cpu().numpy()),
        unpack_detections(floats.cpu().numpy())).as_dict()

    cpu = GraphDetector(str(QDQ_ONNX), cfg, device="cpu")
    out["cuda_vs_cpu"] = qdq_agreement(
        qdq.run_device(frames[:2], pack_output=True),
        cpu.run_device(frames_np[:2], pack_output=True), cfg.min_confidence)

    progs = replica_programs(device, jpegs)
    out["by_program"] = {}
    for name in GRAPH_TAILS:
        got, launches = launches_of(lambda: progs[name](qdq, slice(None)))
        out["by_program"][name] = {
            "launches": launches,
            "sanity": check_packed(_packed(got, name), cfg.min_confidence)}

    two = qdq.to_mesh([device, device])
    got_two, out["launches_two_replicas"] = launches_of(
        lambda: two.run_device(frames, pack_output=True))
    out["two_replicas_identical_per_shard"] = outputs_equal(
        got_two, concat_outputs([qdq.run_device(frames[r], pack_output=True)
                                 for r in (slice(0, 8), slice(8, 16))]))

    calls = {"qdq": lambda: qdq.run_device(frames, pack_output=True),
             "float_graph": lambda: graph.run_device(frames,
                                                     pack_output=True)}
    out["ms_per_batch_in_turns"] = in_turns(calls)
    out["host_ms_per_call"] = {n: host_call_ms(c) for n, c in calls.items()}
    for n, c in calls.items():
        prof = profile_device(c, 10)
        out.setdefault("profile", {})[n] = {
            "device_busy_ms_per_batch": prof["device_ms"],
            "profiled_wall_ms_per_batch": prof["wall_ms"],
            "device_idle_share": prof["idle_share"],
            "device_ops_per_batch": prof["device_ops_per_iter"],
            "top_device_ms": prof["top"][:5]}
    return out


def check_qdq(rec: dict) -> None:
    """The QDQ phase's failure conditions."""
    if rec["launches"] != 1 or not rec["sanity"]["ok"]:
        raise SystemExit(f"qdq run_device: {rec['launches']} nms launches "
                         f"(not 1) or failed sanity {rec['sanity']}")
    if not rec["identical_kernel_vs_plain"]:
        raise SystemExit("qdq run_device: kernel and plain NMS differ")
    if rec["host_copies_a_call"]:
        raise SystemExit(f"qdq run_device copied {rec['host_copies_a_call']} "
                         f"values from the host")
    if not rec["cuda_vs_cpu"]["ok"]:
        raise SystemExit(f"qdq run_device on the card differs from the "
                         f"CPU's: {rec['cuda_vs_cpu']}")
    for name, r in rec["by_program"].items():
        if r["launches"] != 1 or not r["sanity"]["ok"]:
            raise SystemExit(f"qdq {name}: {r['launches']} nms launches or "
                             f"failed sanity {r['sanity']}")
    if rec["launches_two_replicas"] != 2 or not rec[
            "two_replicas_identical_per_shard"]:
        raise SystemExit("qdq to_mesh over two replicas: "
                         f"{rec['launches_two_replicas']} launches, "
                         f"identical per shard "
                         f"{rec['two_replicas_identical_per_shard']}")


# -- the graph runtime's other op families, card against CPU --------------

OP_EXPORTS = {
    # committed export: (input shapes, the CPU tests' tolerance)
    "crnn_opset13.onnx": ([(2, 1, 32, 24)], 1e-4),
    "norms_activations_opset18.onnx": ([(2, 6, 5, 4)], 1e-4),
    "einsum_logsoftmax_cumsum_opset13.onnx": ([(2, 3, 4), (2, 4, 5)], 1e-5),
}


def _control_graphs():
    """Hand-built control flow (the port's reader classes): a
    data-dependent If, a data-dependent Loop (x doubles while x < 10) and
    a Scan (a running sum)."""
    import numpy as np

    from infercam_onnx_tpu_torch.models.onnx_reader import (OnnxGraph,
                                                            OnnxNode,
                                                            OnnxValueInfo)

    def info(name, elem=1, shape=()):
        return OnnxValueInfo(name, elem, list(shape))

    def branch(op, const):
        return OnnxGraph(nodes=[OnnxNode(op, op, ["x", "k"], ["y"], {})],
                         initializers={"k": np.float32(const)}, inputs=[],
                         outputs=[info("y", shape=[3])])

    if_graph = OnnxGraph(
        nodes=[OnnxNode("ReduceSum", "s", ["x"], ["sum"], {"keepdims": 0}),
               OnnxNode("Greater", "g", ["sum", "zero"], ["pos"], {}),
               OnnxNode("If", "pick", ["pos"], ["out"], {
                   "then_branch": branch("Mul", 2.0),
                   "else_branch": branch("Sub", 1.0)})],
        initializers={"zero": np.float32(0.0)}, inputs=[info("x", shape=[3])],
        outputs=[info("out", shape=[3])])
    body = OnnxGraph(
        nodes=[OnnxNode("Mul", "dbl", ["x_in", "two"], ["x_out"], {}),
               OnnxNode("Less", "chk", ["x_out", "limit"], ["cond_out"], {})],
        initializers={"two": np.float32(2.0)},
        inputs=[info("iter", 7), info("cond_in", 9), info("x_in")],
        outputs=[info("cond_out", 9), info("x_out")])
    loop_graph = OnnxGraph(
        nodes=[OnnxNode("Less", "c0", ["x", "limit"], ["go"], {}),
               OnnxNode("Loop", "L", ["", "go", "x"], ["final"],
                        {"body": body})],
        initializers={"limit": np.float32(10.0)}, inputs=[info("x")],
        outputs=[info("final")])
    scan_body = OnnxGraph(
        nodes=[OnnxNode("Add", "acc", ["s_in", "x_t"], ["s_out"], {}),
               OnnxNode("Identity", "y", ["s_out"], ["y_t"], {})],
        initializers={}, inputs=[info("s_in"), info("x_t")],
        outputs=[info("s_out"), info("y_t")])
    scan_graph = OnnxGraph(
        nodes=[OnnxNode("Scan", "S", ["init", "xs"], ["final", "ys"],
                        {"body": scan_body, "num_scan_inputs": 1})],
        initializers={}, inputs=[info("init"), info("xs", shape=[None])],
        outputs=[info("final"), info("ys", shape=[None])])
    return if_graph, loop_graph, scan_graph


def graph_ops(device) -> dict:
    """Each op family the graph runtime gained beyond its CNN set, on the
    card against the port on the CPU, float32 with TF32 off
    (`config.full_float32`): the committed CRNN, norms/activations and
    einsum/logsoftmax/cumsum exports; gather/scatter, GridSample and
    RoiAlign on seeded inputs; a data-dependent If and Loop inside
    torch.func.vmap and a Scan; MatMulInteger, ConvInteger and QLinearConv
    bit-equal. Each its largest difference and its tolerance."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import full_float32
    from infercam_onnx_tpu_torch.models import onnx_exec as px
    from infercam_onnx_tpu_torch.models.onnx_reader import (OnnxNode,
                                                            read_onnx_graph)

    rng = np.random.default_rng(9)
    cpu = torch.device("cpu")
    out = {}

    def on(device_, args):
        return [torch.from_numpy(np.array(a)).to(device_) for a in args]

    def record(name, card, host, tol):
        card = [c.cpu() for c in _outputs(card)]
        host = _outputs(host)
        exact = all(c.dtype == h.dtype and torch.equal(c, h)
                    for c, h in zip(card, host))
        diff = max(float((c.double() - h.double()).abs().max())
                   if c.numel() else 0.0 for c, h in zip(card, host))
        shapes = all(c.shape == h.shape for c, h in zip(card, host))
        out[name] = {"max_abs_diff": diff, "tolerance": tol,
                     "bit_equal": exact,
                     "ok": shapes and (exact if tol == 0 else diff <= tol)}

    with full_float32():
        for name, (shapes, tol) in OP_EXPORTS.items():
            graph = read_onnx_graph(str(REPO / "tests" / "fixtures" / name))
            ex = px.GraphExecutor(graph)
            inputs = [rng.normal(size=s).astype(np.float32) * 0.5
                      for s in shapes]
            host = ex(*on(cpu, inputs))
            card = ex.to(device)(*on(device, inputs))
            record(name.removesuffix(".onnx"), card, host, tol)

        x = rng.normal(size=(1, 3, 8, 10)).astype(np.float32)
        rois = np.array([[1.0, 1.0, 7.0, 5.0], [0.0, 0.0, 3.0, 2.0],
                         [2.0, 0.5, 9.5, 7.5]], np.float32)
        cases = {
            "GatherElements": ("GatherElements", dict(axis=1), (
                rng.normal(size=(4, 6)).astype(np.float32),
                rng.integers(-6, 6, size=(4, 9))), 0),
            "GatherND_batch": ("GatherND", dict(batch_dims=1), (
                rng.normal(size=(3, 5, 4)).astype(np.float32),
                rng.integers(0, 5, size=(3, 2, 1))), 0),
            "ScatterElements_add": ("ScatterElements", dict(
                axis=0, reduction=b"add"), (
                rng.normal(size=(5, 4)).astype(np.float32),
                rng.integers(0, 5, size=(8, 4)),
                rng.normal(size=(8, 4)).astype(np.float32)), 1e-5),
            "ScatterND_max": ("ScatterND", dict(reduction=b"max"), (
                rng.normal(size=(6, 3)).astype(np.float32),
                rng.integers(0, 6, size=(5, 1)),
                rng.normal(size=(5, 3)).astype(np.float32)), 0),
            "GridSample_bilinear": ("GridSample", dict(mode=b"bilinear"), (
                rng.normal(size=(2, 3, 6, 7)).astype(np.float32),
                rng.uniform(-1.4, 1.4, size=(2, 4, 5, 2)).astype(
                    np.float32)), 1e-5),
            "GridSample_bicubic_reflection": ("GridSample", dict(
                mode=b"bicubic", padding_mode=b"reflection"), (
                rng.normal(size=(2, 3, 6, 7)).astype(np.float32),
                rng.uniform(-1.4, 1.4, size=(2, 4, 5, 2)).astype(
                    np.float32)), 1e-4),
            "GridSample_3d": ("GridSample", dict(mode=b"nearest",
                                                 padding_mode=b"border"), (
                rng.normal(size=(2, 2, 4, 5, 6)).astype(np.float32),
                rng.uniform(-1.4, 1.4, size=(2, 3, 2, 4, 3)).astype(
                    np.float32)), 1e-5),
            "RoiAlign": ("RoiAlign", dict(output_height=2, output_width=3,
                                          sampling_ratio=2),
                         (x, rois, np.zeros(3, np.int64)), 1e-5),
            "RoiAlign_adaptive_max": ("RoiAlign", dict(
                output_height=2, output_width=3, mode=b"max"),
                (x, rois, np.zeros(3, np.int64)), 1e-5),
            "MatMulInteger": ("MatMulInteger", {}, (
                rng.integers(0, 256, size=(64, 300)).astype(np.uint8),
                rng.integers(-128, 128, size=(300, 48)).astype(np.int8),
                np.uint8(113), np.int8(-7)), 0),
            "ConvInteger": ("ConvInteger", dict(pads=[1, 1, 1, 1]), (
                rng.integers(0, 256, size=(2, 64, 20, 24)).astype(np.uint8),
                rng.integers(-128, 128, size=(32, 64, 3, 3)).astype(np.int8),
                np.uint8(100), np.int8(5)), 0),
            "QLinearConv": ("QLinearConv", dict(pads=[1, 1, 1, 1], group=2), (
                rng.integers(0, 256, size=(2, 64, 20, 24)).astype(np.uint8),
                np.float32(0.02), np.uint8(120),
                rng.integers(-128, 128, size=(32, 32, 3, 3)).astype(np.int8),
                rng.uniform(1e-3, 1e-2, size=32).astype(np.float32),
                np.zeros(32, np.int8), np.float32(0.05), np.uint8(20),
                rng.integers(-2000, 2000, size=32).astype(np.int32)), 0),
        }
        for name, (op, attrs, args, tol) in cases.items():
            node = OnnxNode(op, name, [], ["y"], attrs)
            host = px._OPS[op](node, *on(cpu, args))
            card = px._OPS[op](node, *on(device, args))
            record(name, card, host, tol)

        if_graph, loop_graph, scan_graph = _control_graphs()
        xs = rng.normal(size=(16, 3)).astype(np.float32)
        starts = rng.uniform(0.01, 20.0, size=16).astype(np.float32)
        seqs = rng.normal(size=(16, 7)).astype(np.float32)
        for name, graph, args in (
                ("If_traced_under_vmap", if_graph, (xs,)),
                ("Loop_data_dependent_under_vmap", loop_graph, (starts,)),
                ("Scan_under_vmap", scan_graph, (np.zeros(16, np.float32),
                                                 seqs))):
            ex = px.GraphExecutor(graph)
            host = torch.func.vmap(ex)(*on(cpu, args))
            card = torch.func.vmap(ex.to(device))(*on(device, args))
            record(name, card, host, 1e-6)
            out[name]["host_copies_a_call"] = ex.host_copies
    return out


def check_graph_ops(rec: dict) -> None:
    bad = {k: v for k, v in rec.items()
           if not v["ok"] or v.get("host_copies_a_call", 0)}
    if bad:
        raise SystemExit(f"graph ops on the card differ from the CPU's: {bad}")


# -- phases 4k-4m: the weights chain, the goldens CLI, onnx_run ----------------

@contextlib.contextmanager
def private_cache():
    """``XDG_CACHE_HOME`` pointed at a temporary directory for the block,
    restored after: the weights chain reads and writes nothing of the
    host's cache, and no later phase finds what this one cached."""
    import os

    saved = os.environ.get("XDG_CACHE_HOME")
    with tempfile.TemporaryDirectory() as home:
        os.environ["XDG_CACHE_HOME"] = home
        try:
            yield pathlib.Path(home)
        finally:
            if saved is None:
                del os.environ["XDG_CACHE_HOME"]
            else:
                os.environ["XDG_CACHE_HOME"] = saved


def weights_chain(device) -> dict:
    """`Detector` without weights (float32) under a private user cache
    holding the committed twin export at ``cached_model_path("RFB-320")``:
    its packed output on the 16 synthetic 640x480 frames must equal the
    detector given ``params_from_onnx`` of the export bit for bit, with one
    NMS launch a call; the .npz cache it writes must give a bit-identical
    detector again, and so must a truncated .npz, which is rebuilt. Then
    the seconds one ``load_or_download_params("slim-320")`` takes with
    nothing cached and the stock downloader pointed at a closed local
    port (the run reaches no outside host), and that it returns None."""
    import shutil

    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.models import checkpoint, convert
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.utils import download

    frames = synthetic_batch(16, 640, 480)
    config = DetectorConfig(compute_dtype="float32")
    want = Detector(config, params=convert.params_from_onnx(str(GRAPH_ONNX)),
                    device=device).run_device(frames, pack_output=True).cpu()
    out: dict = {"variant": "RFB-320", "dtype": "float32", "batch": 16,
                 "frame": [640, 480]}
    with private_cache() as home:
        shutil.copyfile(GRAPH_ONNX, convert.cached_model_path("RFB-320"))
        npz = home / "infercam_onnx_tpu" / "weights" / "ultraface-RFB-320.npz"
        runs = {}
        for step in ("from_cached_onnx", "from_npz_cache", "rebuilt_npz"):
            if step == "rebuilt_npz":
                npz.write_bytes(npz.read_bytes()[:4096])
            t0 = time.perf_counter()
            det = Detector(config, device=device)
            build_s = time.perf_counter() - t0
            nms.kernel.launches = 0
            got = det.run_device(frames, pack_output=True)
            torch.cuda.synchronize()
            runs[step] = {"launches": nms.kernel.launches,
                          "identical_to_explicit_params": bool(
                              torch.equal(got.cpu(), want)),
                          "detections": int(got[..., 5].sum()),
                          "npz_written": npz.is_file(),
                          "detector_build_s": build_s}
        checkpoint.load_params(str(npz))  # the rebuilt cache reads back
        out["runs"] = runs
        real = download.download_file

        def stock_to_closed_port(url, path, *, timeout=60.0):
            closed = f"http://127.0.0.1:{free_ports(1)[0]}/ultraface.onnx"
            return real(closed, path, timeout=timeout)

        download.download_file = stock_to_closed_port
        try:
            t0 = time.perf_counter()
            miss = convert.load_or_download_params("slim-320")
            out["offline_miss_s"] = time.perf_counter() - t0
        finally:
            download.download_file = real
        out["offline_miss_returns_none"] = miss is None
        out["offline_miss_leaves_no_file"] = not pathlib.Path(
            convert.cached_model_path("slim-320")).exists()
    out["launches"] = runs["from_cached_onnx"]["launches"]
    return out


def check_weights_chain(rec: dict) -> None:
    for step, r in rec["runs"].items():
        if r["launches"] != 1:
            raise SystemExit(f"weights_chain {step}: {r['launches']} nms "
                             f"launches a call, not 1")
        if not r["identical_to_explicit_params"] or not r["npz_written"]:
            raise SystemExit(f"weights_chain {step}: {r}")
    if not (rec["offline_miss_returns_none"]
            and rec["offline_miss_leaves_no_file"]):
        raise SystemExit(f"weights_chain: the offline miss {rec}")


GOLDENS_KEYS = ("images", "want_total", "got_total", "box_matched",
                "conf_matched", "box_parity", "conf_parity", "passed",
                "min_parity")


def goldens_cli_start(argv: list[str]) -> subprocess.Popen:
    """``python -m infercam_onnx_tpu_torch.eval.goldens ARGV`` in a child
    process."""
    return subprocess.Popen(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.eval.goldens",
         *argv], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def goldens_cli_result(proc: subprocess.Popen, t0: float) -> dict:
    """A goldens CLI child's exit code, last stdout line (JSON where it is
    one) and seconds since ``t0``; any exit code but 0 and 1 fails."""
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode not in (0, 1):
        raise SystemExit(f"goldens CLI {proc.args[3]} failed (rc "
                         f"{proc.returncode}): {stderr[-3000:]}")
    line = stdout.strip().splitlines()[-1]
    return {"rc": proc.returncode, "s": time.perf_counter() - t0,
            **(json.loads(line) if line.startswith("{") else {"out": line})}


def goldens_cli(device, gold: dict) -> dict:
    """The goldens CLI on ``device`` in child processes: ``check`` on the
    committed fixture (float32, frozen weights) must exit 0 and print the
    in-process goldens phase's counts and parities; ``make`` into a temp
    file and ``check`` against it must give parity 1.0. Then the reference
    oracle on the card: the float32 trunk's outputs on the 16 synthetic
    frames through ``ops/reference_impl.postprocess`` (the reference's
    nn.rs semantics, in NumPy) against the packed output of the same
    detector (the NMS kernel), by ROADMAP C.3."""
    import numpy as np
    import torch

    from infercam_onnx_tpu_torch.config import DetectorConfig, full_float32
    from infercam_onnx_tpu_torch.detector import Detector, unpack_detections
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.ops import reference_impl
    from infercam_onnx_tpu_torch.ops.preprocess import preprocess_images

    flags = ["--device", device.type, "--variant", "RFB-320",
             "--compute-dtype", "float32", "--weights", str(WEIGHTS),
             "--dir", str(SYNTH_PICS)]
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        made = str(pathlib.Path(tmp) / "goldens.json")
        t0 = time.perf_counter()  # check and make at once, then the check
        check = goldens_cli_start(["check", *flags, "--goldens",
                                   str(GOLDENS)])
        make = goldens_cli_start(["make", *flags, "--out", made])
        out["check"] = goldens_cli_result(check, t0)
        out["make"] = goldens_cli_result(make, t0)
        t0 = time.perf_counter()
        out["check_made"] = goldens_cli_result(goldens_cli_start(
            ["check", *flags, "--goldens", made]), t0)
    out["check"]["equals_in_process_goldens"] = all(
        out["check"].get(k) == gold[k] for k in GOLDENS_KEYS)

    det = Detector(DetectorConfig(compute_dtype="float32", top_k=512,
                                  max_detections=256),
                   weights=str(WEIGHTS), device=device)
    frames = synthetic_batch(16, 640, 480)
    nms.kernel.launches = 0
    packed = det.run_device(frames, pack_output=True)
    torch.cuda.synchronize()
    out["launches"] = nms.kernel.launches
    images = torch.from_numpy(frames).to(device)
    with torch.inference_mode(), full_float32():
        x = preprocess_images(images, *det.preprocessor.matrices(640, 480))
        scores, boxes = det.model(x, det.priors)
    scores, boxes = scores.float().cpu().numpy(), boxes.float().cpu().numpy()
    c = det.config
    counts_equal, box_diff, conf_diff, total = True, 0.0, 0.0, 0
    for i, got in enumerate(unpack_detections(packed.cpu().numpy())):
        want = reference_impl.postprocess(scores[i], boxes[i],
                                          c.min_confidence, c.max_iou)
        total += len(want)
        if len(got) != len(want):
            counts_equal = False
            continue
        for (gb, gc), (wb, wc) in zip(got, want):
            box_diff = max(box_diff, float(np.abs(gb - wb).max()))
            conf_diff = max(conf_diff, abs(gc - wc))
    out["reference_oracle_vs_kernel"] = {
        "counts_equal": counts_equal, "detections": total,
        "max_box_diff": box_diff, "max_conf_diff": conf_diff}
    return out


def check_goldens_cli(rec: dict) -> None:
    check = rec["check"]
    if check["rc"] != 0 or not check["passed"]:
        raise SystemExit(f"goldens CLI check failed: {check}")
    if not check["equals_in_process_goldens"]:
        raise SystemExit(f"goldens CLI check differs from the in-process "
                         f"gate: {check}")
    made = rec["check_made"]
    if rec["make"]["rc"] or made["rc"] or (
            made["box_parity"], made["conf_parity"]) != (1.0, 1.0):
        raise SystemExit(f"goldens CLI make then check: {rec['make']}, "
                         f"{made}")
    if rec["launches"] != 1:
        raise SystemExit(f"the goldens detector launched nms "
                         f"{rec['launches']} times a call, not once")
    if not within_c3(rec["reference_oracle_vs_kernel"]):
        raise SystemExit(f"the reference oracle differs from the kernel's "
                         f"detections: {rec['reference_oracle_vs_kernel']}")


ONNX_RUN_EXPORTS = (GRAPH_ONNX, REPO / "tests" / "fixtures"
                    / "crnn_opset13.onnx")
ONNX_RUN_RUNS = 20
ONNX_RUN_TOL = 1e-4  # graph_ops' tolerance for the graph runtime


def onnx_run(device) -> dict:
    """``python -m infercam_onnx_tpu_torch.onnx_run EXPORT --device cuda
    --runs 20`` on the twin and the CRNN exports, and the same on the CPU
    (the CPU runs start first, in the background): each exits 0, the
    card's outputs are within 1e-4 of the CPU's on the same seeded inputs,
    and its ms a run (CUDA events) is printed."""
    import numpy as np

    def start(export, dev, out):
        return subprocess.Popen(
            [sys.executable, "-m", "infercam_onnx_tpu_torch.onnx_run",
             str(export), "--device", dev, "--runs", str(ONNX_RUN_RUNS),
             "--out", out], cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def finish(proc, what) -> str:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode:
            raise SystemExit(f"onnx_run {what} failed (rc {proc.returncode})"
                             f": {stderr[-3000:]}")
        return stdout

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = {(e.stem, d): str(pathlib.Path(tmp) / f"{e.stem}_{d}.npz")
               for e in ONNX_RUN_EXPORTS for d in ("card", "cpu")}
        cpu = {e.stem: start(e, "cpu", npz[e.stem, "cpu"])
               for e in ONNX_RUN_EXPORTS}
        for export in ONNX_RUN_EXPORTS:
            t0 = time.perf_counter()
            stdout = finish(start(export, device.type,
                                  npz[export.stem, "card"]),
                            f"{export.name} --device {device.type}")
            secs = time.perf_counter() - t0
            finish(cpu[export.stem], f"{export.name} --device cpu")
            lines = stdout.strip().splitlines()
            runs = [ln for ln in lines if ln.startswith(f"{ONNX_RUN_RUNS} runs:")]
            with np.load(npz[export.stem, "card"]) as got, \
                    np.load(npz[export.stem, "cpu"]) as want:
                diffs = {k: float(np.abs(got[k].astype(np.float64)
                                         - want[k]).max())
                         for k in want.files}
                same_shapes = got.files == want.files and all(
                    got[k].shape == want[k].shape for k in want.files)
            out[export.stem] = {
                "summary": lines[:-1], "s": secs,
                "ms_a_run": float(runs[0].split()[2]) if runs else None,
                "max_abs_diff_vs_cpu": diffs, "tolerance": ONNX_RUN_TOL,
                "ok": same_shapes and bool(runs) and all(
                    d <= ONNX_RUN_TOL for d in diffs.values())}
    return out


def check_onnx_run(rec: dict) -> None:
    bad = {k: v for k, v in rec.items() if not v["ok"]}
    if bad:
        raise SystemExit(f"onnx_run on the card differs from the CPU's or "
                         f"printed no timing: {bad}")


# -- phase 4n: the model-level API ---------------------------------------

MODEL_API_VARIANTS = ("RFB-320", "RFB-640")
MODEL_API_CALLS = 3  # create-path calls counted per variant
MODEL_API_BF16_TOL = 0.03  # tests/test_torch_port_model.py's bf16 bound


def model_api(device) -> dict:
    """The model-level path a JAX user writes, on the card in float32, for
    RFB-320 and RFB-640 on synthetic_batch(16, 640, 480) (random weights
    of seed 0): ``ops.Preprocessor(w, h)(frames)``, then
    ``UltraFace.create(variant, rng=0)(x)``, then ``ops.batched_postprocess``
    with the DetectorConfig thresholds and ``pack_detections``. Its packed
    output must equal ``Detector(..., params=model.params).run_device``'s
    bit for bit, with one NMS launch a ``batched_postprocess`` call (the
    count set to 0 just before the calls and read just after); the
    functional ``forward(model.params, x, model.priors)`` must equal
    ``model(x)`` bit for bit; ``model(x, compute_dtype=torch.bfloat16)``
    against the bfloat16 Detector's trunk shows its largest score
    difference (<= 0.03). ms a batch of the create path and of
    ``Detector.run_device`` by CUDA events, in turns."""
    import torch

    from infercam_onnx_tpu_torch import ops
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector, pack_detections
    from infercam_onnx_tpu_torch.models import UltraFace, forward
    from infercam_onnx_tpu_torch.ops import nms

    frames = synthetic_batch(16, 640, 480)
    images = torch.from_numpy(frames).to(device)
    out = {"by_variant": {}, "launches": 0, "calls": 0}
    for variant in MODEL_API_VARIANTS:
        config = DetectorConfig(variant=variant, compute_dtype="float32")
        kw = dict(min_confidence=config.min_confidence,
                  max_iou=config.max_iou, top_k=config.top_k,
                  max_detections=config.max_detections)
        model = UltraFace.create(variant, rng=0, device=device)
        prep = ops.Preprocessor(model.width, model.height, device=device)

        @torch.inference_mode()
        def create_path():
            scores, boxes = model(prep(images))
            return pack_detections(*ops.batched_postprocess(scores, boxes,
                                                            **kw))

        det = Detector(config, params=model.params, device=device)
        det.warmup(16, 480, 640, pack_output=True)
        create_path()
        torch.cuda.synchronize()
        nms.kernel.launches = 0
        outs = [create_path() for _ in range(MODEL_API_CALLS)]
        torch.cuda.synchronize()
        launches = nms.kernel.launches
        want = det.run_device(images, pack_output=True)
        with torch.inference_mode():
            x = prep(images)
            trunk = model(x)
            functional = forward(model.params, x, model.priors)
            s16, _ = model(x, compute_dtype=torch.bfloat16)
            det16 = Detector(DetectorConfig(variant=variant),
                             params=model.params, device=device)
            d16, _ = det16.model(x, det16.priors)
        torch.cuda.synchronize()
        times = in_turns({
            "create_path": create_path,
            "detector_run_device": lambda: det.run_device(
                images, pack_output=True)}, iters=10)
        out["launches"] += launches
        out["calls"] += MODEL_API_CALLS
        out["by_variant"][variant] = {
            "launches": launches, "calls": MODEL_API_CALLS,
            "identical_to_detector": all(torch.equal(o, want) for o in outs),
            "functional_forward_identical": all(
                torch.equal(a, b) for a, b in zip(functional, trunk)),
            "priors_float32_in_bf16_detector":
                det16.model.priors.dtype == torch.float32,
            "bf16_max_score_diff_vs_detector": float(
                (s16[..., 1] - d16[..., 1]).abs().max()),
            "bf16_tolerance": MODEL_API_BF16_TOL,
            "sanity": check_packed(outs[0], config.min_confidence),
            "ms_per_batch_in_turns": times}
    return out


def check_model_api(rec: dict) -> None:
    if rec["launches"] != rec["calls"]:
        raise SystemExit(f"model_api: {rec['launches']} NMS launches for "
                         f"{rec['calls']} batched_postprocess calls")
    for variant, r in rec["by_variant"].items():
        if not (r["identical_to_detector"] and r["sanity"]["ok"]
                and r["functional_forward_identical"]
                and r["priors_float32_in_bf16_detector"]
                and r["bf16_max_score_diff_vs_detector"]
                <= MODEL_API_BF16_TOL):
            raise SystemExit(f"model_api {variant} failed its checks: {r}")


SERVE_STREAMS = 16
SERVE_FPS = 30.0
SERVE_SECONDS = 10.0
SERVE_STAGES = ("decode", "upload", "device", "device_ycbcr", "device_coef",
                "device_annot", "device_tiled", "draw", "encode")
SERVE_CHECK_FRAMES = 4  # per stream, in the check round before the window
SERVE_LAG_CYCLES = 300_000_000  # ~0.15 s of the card after a checked batch
# the tiled serve phase: 4 cameras at 15 fps of 1080p
TILED_STREAMS, TILED_FPS = 4, 15.0
TILE_MIN_PIXELS = 1280 * 720


def serve_names(streams: int) -> list[str]:
    return [f"cam{i}" for i in range(streams)]


class HttpViewer:
    """One GET on a streaming endpoint of the server, its body gathered
    as it arrives (into a bytearray: the MJPEG viewer takes tens of MB)."""

    def __init__(self, reader, writer):
        import asyncio

        self._reader, self._writer = reader, writer
        self.data = bytearray()
        self._task = asyncio.ensure_future(self._read())

    @classmethod
    async def open(cls, port: int, path: str):
        import asyncio

        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        await writer.drain()
        return cls(reader, writer)

    async def _read(self):
        while chunk := await self._reader.read(1 << 16):
            self.data += chunk

    def body(self) -> bytes:
        return bytes(self.data).split(b"\r\n\r\n", 1)[-1]

    async def close(self):
        import asyncio

        self._writer.close()
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)


async def load_generator(http_port: int, socket_port: int, streams: int,
                         fps: float, pics: str) -> None:
    """The serve phase's traffic, in a process of its own, as the edge
    senders and viewers of a deployment are: a /detections viewer per
    stream and a /face_stream viewer on stream 0. Each "send N" read from
    stdin runs the port's sender on every one of ``streams`` streams for N
    frames of the JPEGs in ``pics`` at ``fps`` and prints {"sent",
    "send_s"}; "stop" closes the viewers and prints what they received."""
    import asyncio

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.client.sender import ReplaySource, send_stream
    from infercam_onnx_tpu_torch.config import ClientConfig
    from infercam_onnx_tpu_torch.protocol import _MJPEG_HEADER

    loop = asyncio.get_running_loop()

    async def command() -> list[str]:
        return (await loop.run_in_executor(None, sys.stdin.readline)).split()

    names = serve_names(streams)
    dets = [await HttpViewer.open(http_port, f"/detections?name={n}")
            for n in names]
    faces = await HttpViewer.open(http_port, f"/face_stream?name={names[0]}")
    address = f"127.0.0.1:{socket_port}"
    while (cmd := await command())[:1] == ["send"]:
        start = time.perf_counter()
        sent = sum(await asyncio.gather(*(
            send_stream(ReplaySource(pics, fps=fps),
                        ClientConfig(address=address, channel=n),
                        max_frames=int(cmd[1]))
            for n in names)))
        emit({"sent": sent, "send_s": time.perf_counter() - start})
    for viewer in (*dets, faces):
        await viewer.close()
    parts = [p[:-4] for p in faces.body().split(_MJPEG_HEADER)[1:]
             if p.endswith(b"\xff\xd9\r\n\r\n")]
    emit({"records": [v.body().decode().split("\n")[:-1] for v in dets],
          "face_parts": len(parts),
          "face_part_shapes": sorted({codec.decode_rgb(p).shape
                                      for p in parts})})


async def _until(cond, timeout_s: float, what: str) -> None:
    import asyncio

    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            raise SystemExit(f"serve phase: {what} within {timeout_s} s")
        await asyncio.sleep(0.01)


def _detections(packed_row) -> list[dict]:
    """The "detections" of the NDJSON record of one packed output row."""
    return [{"bbox": [float(v) for v in packed_row[d, :4]],
             "confidence": float(packed_row[d, 4])}
            for d in range(int(packed_row[:, 5].sum()))]


def expected_face_jpeg(unit: dict, outs: list, i: int) -> bytes:
    """The /face_stream JPEG of row ``i`` of a device-annotated unit, from
    its program's outputs (host arrays, packed detections last) computed
    outside the worker: the encoded coefficients, or the splice (the host
    draw from the JPEG bytes where the splice falls back)."""
    import numpy as np

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.detector import unpack_detections
    from infercam_onnx_tpu_torch.draw import draw_detections
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import jpeg_encode_device as enc

    shim = native_jpeg.load()
    if unit["kind"] == "coef_annot":
        job, (y, cb, cr, quant, wh, samp) = unit["members"][i]
        blocks, meta = outs[0][i], outs[1][i]
        if meta[0] <= SPLICE_K and np.array_equal(quant[0, 1], quant[0, 2]):
            return shim.encode_coefs(*enc.splice_blocks(
                y[0], cb[0], cr[0], meta, blocks), wh, samp, quant[0, :2])
        dets = unpack_detections(outs[-1][i:i + 1])[0]
        return codec.encode_rgb(draw_detections(codec.decode_rgb(job.data),
                                                dets))
    geom = unit["geom"] or enc.plane_geometry(unit["w"], unit["h"], (2, 2))
    return shim.encode_coefs(*enc.split_coefs(outs[0][i], geom),
                             (geom["width"], geom["height"]), geom["sampling"],
                             native_jpeg.quant_tables_cached(95))


async def get_json(port: int, path: str) -> dict:
    """One GET of a JSON endpoint of the server."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                 f"Connection: close\r\n\r\n".encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), 30.0)
    writer.close()
    return json.loads(data.split(b"\r\n\r\n", 1)[1])


async def _serve(device, decode_mode: str, annotate_mode: str, *,
                 streams: int, fps: float, frame: tuple[int, int],
                 pics: pathlib.Path, onnx: pathlib.Path | None = None,
                 **engine_kw) -> dict:
    import asyncio

    import torch

    from infercam_onnx_tpu_torch.config import EngineConfig, ServerConfig
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.ops import nms
    from infercam_onnx_tpu_torch.serving.app import start_server
    from infercam_onnx_tpu_torch.serving.meter import METER
    from infercam_onnx_tpu_torch.serving.router import stream_key
    from infercam_onnx_tpu_torch.utils.profiling import STAGES

    if onnx:
        from infercam_onnx_tpu_torch.config import DetectorConfig
        from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

        det = GraphDetector(str(onnx),
                            DetectorConfig(compute_dtype="float32"),
                            device=device)
    else:
        det = Detector(weights=str(WEIGHTS), device=device)  # bfloat16
    t0 = time.perf_counter()
    server = await start_server(
        # the phase drains the meter itself, once, after the window
        ServerConfig(http_address="127.0.0.1:0", socket_address="127.0.0.1:0",
                     meter_period_s=3600.0),
        engine_config=EngineConfig(batch_buckets=(1, 2, 4, 8, 16),
                                   queue_capacity=32, batch_window_ms=4.0,
                                   coalesce_streams=True,
                                   decode_mode=decode_mode,
                                   annotate_mode=annotate_mode,
                                   link_adaptive=True, **engine_kw),
        detector=det, warmup_resolutions=[frame[::-1]])
    warmup_s = time.perf_counter() - t0
    link_stats = (await get_json(server.http_port, "/stats"))["link"]

    worker, router = server.worker, server.router
    keys = [stream_key(n) for n in serve_names(streams)]
    proc = await asyncio.create_subprocess_exec(
        sys.executable, str(REPO / "chip_smoke.py"), "--load-generator",
        str(server.http_port), str(server.socket_port), str(streams),
        str(fps), str(pics), cwd=str(REPO),
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE)

    async def send(frames: int) -> dict:
        """One round of the load generator's senders, until every frame
        sent was served or dropped (counted from the last meter drain)."""
        proc.stdin.write(f"send {frames}\n".encode())
        await proc.stdin.drain()
        line = await asyncio.wait_for(proc.stdout.readline(),
                                      SERVE_SECONDS + 60)
        if not line:
            raise SystemExit("serve phase: the load generator died")
        load = json.loads(line)
        await _until(
            lambda: METER.inferred_unique + METER.dropped >= load["sent"],
            10.0, "the frames sent were not all served or dropped")
        return load

    # The check round, before the measured window, records every unit the
    # worker dispatched (each batch with its members in row order) and
    # every NDJSON record and /face_stream part it handed to a broadcast.
    # The card is held back after each batch's program, before its
    # readback, for longer than a decode, so a publish stage that read the
    # pinned outputs before the readback's event would publish buffers the
    # copy has not filled yet; without the lag the host, far slower than
    # the card, never reads early.
    dispatched, published = [], {}
    device_stage, publish = worker._device_stage, worker._publish

    def device_tap(units):
        dispatched.extend(units)
        return device_stage(units)

    def publish_tap(chan, item):
        if id(chan) in published:
            published[id(chan)].append(item)
        publish(chan, item)

    def lagging(program):
        def run(*args, **kwargs):
            out = program(*args, **kwargs)
            torch.cuda._sleep(SERVE_LAG_CYCLES)  # on the compute stream
            return out
        return run

    try:
        def watched():
            chans = [router._detections.get(k) for k in keys]
            chans.append(router._inferred.get(keys[0]))
            return all(c is not None and c.receiver_count for c in chans)

        await _until(watched, 60.0, "the viewers did not subscribe")
        det_chans = {k: router._detections[k] for k in keys}
        face_chan = router._inferred[keys[0]]
        published.update((id(c), []) for c in (*det_chans.values(),
                                                face_chan))
        worker._device_stage, worker._publish = device_tap, publish_tap
        worker._program = lagging(worker._program)  # every unit kind's
        METER.drain()
        try:
            await send(SERVE_CHECK_FRAMES)
        finally:
            worker._device_stage, worker._publish = device_stage, publish
            del worker._program

        # the measured window, through the worker as it is
        METER.drain()
        STAGES.drain()
        nms.kernel.launches = 0
        start = time.perf_counter()
        load = await send(int(fps * SERVE_SECONDS))
        window_s = time.perf_counter() - start
        launches = nms.kernel.launches
        snap, stages = METER.drain(), STAGES.drain()
        proc.stdin.write(b"stop\n")
        await proc.stdin.drain()
        load.update(json.loads(await asyncio.wait_for(proc.stdout.read(),
                                                      60)))
        await proc.wait()
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        await server.close()

    records = [[json.loads(line) for line in lines]
               for lines in load["records"]]
    frame_ok = all((r["width"], r["height"]) == tuple(frame)
                   and all(d["confidence"] > det.config.min_confidence
                           for d in r["detections"])
                   for recs in records for r in recs)

    # each checked batch's published records against its program run on
    # the same padded batch outside the worker: a stream's n-th record is
    # its row in the n-th batch that holds it; stream 0's /face_stream
    # parts, in order, against the JPEG made from that program's outputs
    # (device annotation; the host path's parts are not checked)
    from infercam_onnx_tpu_torch.protocol import as_jpeg_stream_item

    torch.cuda.synchronize()
    identical, seen, ahead = [], 0, {k: 0 for k in keys}
    faces_identical, face_ahead = [], 0
    viewer_lines = {k: set(lines) for k, lines in zip(keys,
                                                      load["records"])}
    for unit in dispatched:
        members = [job.key for job, _ in unit["members"]]
        outs = worker._program(unit)
        outs = [t.cpu().numpy() for t in (
            outs if isinstance(outs, tuple) else (outs,))]
        want = outs[-1]
        served = [published[id(det_chans[k])][ahead[k]] for k in members]
        identical.append([json.loads(item)["detections"] for item in served]
                         == [_detections(want[i])
                             for i in range(len(members))])
        seen += sum(item.decode().rstrip("\n") in viewer_lines[k]
                    for k, item in zip(members, served))
        for k in members:
            ahead[k] += 1
        for i, (job, _) in enumerate(unit["members"]):
            if job.reply is None:
                continue
            part = published[id(face_chan)][face_ahead]
            face_ahead += 1
            if unit["kind"] != "pixels" or unit["annotate"]:
                faces_identical.append(part == as_jpeg_stream_item(
                    expected_face_jpeg(unit, outs, i)))

    e2e = stages.get("e2e", {})
    return {
        "model": "RFB-320", "runtime": "graph" if onnx else "native",
        "onnx": str(onnx.relative_to(REPO)) if onnx else None,
        "dtype": det.config.compute_dtype, "decode_mode": decode_mode,
        "annotate_mode": annotate_mode, "streams": streams,
        "fps_per_stream": fps, "frame": list(frame),
        "engine": engine_kw, "link": link_stats,
        "tiled_route": worker._effective_tiled_route,
        "load_generator": "a child process: the port's senders and the "
                          "HTTP viewers in one event loop",
        "warmup_s": warmup_s, "send_s": load["send_s"], "window_s": window_s,
        "frames_sent": load["sent"], "frames_inferred": snap["inferred_unique"],
        "frames_dropped": snap["dropped"],
        "inferred_fps": snap["inferred_unique"] / window_s,
        "batches": snap["batches"], "mean_batch": snap["mean_batch"],
        "nms_launches": launches,
        "e2e_p50_ms": e2e.get("p50_ms"), "e2e_p99_ms": e2e.get("p99_ms"),
        "stage_mean_ms": {s: stages[s]["total_ms"] / stages[s]["count"]
                          for s in SERVE_STAGES if s in stages},
        "stage_count": {s: stages[s]["count"] for s in SERVE_STAGES
                        if s in stages},
        "detection_records": [len(r) for r in records],
        "detection_records_ok": frame_ok,
        "face_parts": load["face_parts"],
        "face_part_shapes": load["face_part_shapes"],
        "splice_fallbacks": worker.splice_fallbacks,
        # the check round, before the window
        "checked_batch_buckets": [u["n"] for u in dispatched],
        "checked_batch_kinds": dict(collections.Counter(
            u["kind"] + ("_annot" if u["annotate"] else "")
            for u in dispatched)),
        "checked_records": sum(u["n"] for u in dispatched),
        "checked_records_seen_by_viewers": seen,
        "checked_batches_lag_cycles": SERVE_LAG_CYCLES,
        "served_identical_to_run_device": identical,
        "checked_face_parts_identical": faces_identical,
    }


def serve_phase(device, decode_mode: str = "pixels",
                annotate_mode: str = "host", *, streams: int = SERVE_STREAMS,
                fps: float = SERVE_FPS, frame: tuple[int, int] = (640, 480),
                pics: pathlib.Path = SYNTH_PICS,
                onnx: pathlib.Path | None = None, **engine_kw) -> dict:
    """The port's server in this process on ``device``: RFB-320 bfloat16
    on the frozen weights (with ``onnx``, GraphDetector on that committed
    export of the same weights, float32), buckets 1-16, queue 32, a 4 ms
    gather window,
    coalescing, ``decode_mode`` decode at scale 1 and ``annotate_mode``
    annotation, the link probe on (and ``engine_kw``), warmed up at
    ``frame`` (width, height).
    The traffic comes from ``load_generator`` in a child process:
    ``streams`` port senders replay the JPEGs of ``pics`` (``frame``
    sized) at ``fps`` each, first for SERVE_CHECK_FRAMES frames (the check
    round), then for 10 s (the measured window); every stream has a
    /detections viewer, stream 0 a /face_stream viewer too. The NMS launch
    count is set to 0 just before the window's senders start and read once
    every frame sent was served or dropped."""
    import asyncio

    return asyncio.run(_serve(device, decode_mode, annotate_mode,
                              streams=streams, fps=fps, frame=frame,
                              pics=pics, onnx=onnx, **engine_kw))


def check_tiled(tiled: dict) -> None:
    """The tiled phase's failure conditions."""
    for scale, rec in tiled["by_scale"].items():
        bad = {n: c for n, c in rec["launches"].items() if c != 1}
        if bad:
            raise SystemExit(f"tiled programs at scale {scale} launched the "
                             f"nms kernel {bad} times, not once")
        if not all(s["ok"] for s in rec["sanity"].values()):
            raise SystemExit("tiled output failed its sanity checks")
        if not all(rec["kernel_equals_scan"].values()):
            raise SystemExit(f"a tiled program's output differs between "
                             f"the kernel and the plain scan at scale "
                             f"{scale}: {rec['kernel_equals_scan']}")
        if not rec["rows_equal_packed"]:
            raise SystemExit("the tiled rows program differs from the "
                             "packed one")
        one = rec["grid_1x1_vs_untiled"]
        if not one["counts_equal"] or one["max_box_diff"] > 1e-5:
            raise SystemExit(f"a 1x1 grid differs from the untiled "
                             f"program: {one}")
    if not tiled["float32_ycbcr_vs_pixels"]["ok"]:
        raise SystemExit(f"the float32 tiled ycbcr program fails the JAX "
                         f"bar against the pixels one: "
                         f"{tiled['float32_ycbcr_vs_pixels']}")
    f32 = tiled["float32_cuda_vs_cpu"]
    check_card_vs_cpu(f32, "the float32 tiled program")
    if f32["moved_by_tf32"]:
        raise SystemExit("the float32 tiled program moved with TF32")


def check_serve(serve: dict) -> None:
    """The serve phase's failure conditions."""
    if not serve["frames_inferred"]:
        raise SystemExit("the server inferred no frame")
    if serve["nms_launches"] != serve["batches"]:
        raise SystemExit(f"the server launched the nms kernel "
                         f"{serve['nms_launches']} times for "
                         f"{serve['batches']} batches")
    w, h = serve["frame"]
    if not serve["face_parts"] or serve["face_part_shapes"] != [[h, w, 3]]:
        raise SystemExit(f"/face_stream parts are not all {w}x{h}: "
                         f"{serve['face_part_shapes']}")
    decisions = serve["link"]["decisions"]
    for key in ("decode_mode", "annotate_mode"):
        if decisions[key]["effective"] != serve[key]:
            raise SystemExit(f"the link probe moved the {key}: "
                             f"{decisions[key]}")
    if not min(serve["detection_records"]) or not serve["detection_records_ok"]:
        raise SystemExit("a /detections viewer got no or malformed records")
    ident = serve["served_identical_to_run_device"]
    if not ident or not all(ident):
        raise SystemExit("a served batch's detections differ from its "
                         "program's on the same padded batch")
    if not all(serve["checked_face_parts_identical"]):
        raise SystemExit("a served /face_stream part differs from the JPEG "
                         "of its program's outputs on the same padded batch")
    if serve["annotate_mode"] == "device" and not serve["engine"].get(
            "tile_min_pixels"):
        annot = {"pixels": "pixels_annot", "ycbcr": "ycbcr_annot",
                 "coefficients": "coef_annot"}[serve["decode_mode"]]
        if (not serve["checked_batch_kinds"].get(annot)
                or not serve["checked_face_parts_identical"]):
            raise SystemExit(f"no checked batch took the annotated unit "
                             f"({annot})")


def check_sharded(rec: dict) -> None:
    """The sharded phase's failure conditions."""
    for name, by_dtype in rec["by_program"].items():
        for dtype, r in by_dtype.items():
            what = f"{name} ({dtype})"
            if (r["launches_one_replica"], r["launches_two_replicas"]) != (
                    1, 2):
                raise SystemExit(f"{what}: nms launches a call over one and "
                                 f"two replicas {r['launches_one_replica']}"
                                 f", {r['launches_two_replicas']}, not 1, 2")
            if not r["one_replica_identical"]:
                raise SystemExit(f"{what}: one replica differs from the "
                                 f"plain detector")
            if not r["two_replicas_identical_per_shard"]:
                raise SystemExit(f"{what}: two replicas differ from the "
                                 f"plain detector on each shard's rows")
            if dtype == "float32" and not within_c3(r["two_replicas_vs_b16"]):
                raise SystemExit(f"{what}: two replicas are not within C.3 "
                                 f"of the 16-row call: "
                                 f"{r['two_replicas_vs_b16']}")
    for name, r in rec["tiled"]["by_input"].items():
        if r["launches"] != {"split_tiles": 1, "batch_sharded_out": 2}:
            raise SystemExit(f"tiled {name} on two replicas launched nms "
                             f"{r['launches']} times a call")
        if not r["batch_sharded_out_identical_per_shard"]:
            raise SystemExit(f"tiled {name}, batch_sharded_out: differs from "
                             f"the plain TiledDetector on each shard")
    for name, a in rec["tiled"]["float32_split_tiles_vs_plain"].items():
        if not within_c3(a):
            raise SystemExit(f"tiled {name}, tiles split over two replicas "
                             f"(float32): not within C.3 of the plain "
                             f"TiledDetector: {a}")


# -- phase 5e: a lockstep cluster of two serve processes on one card --------

LOCKSTEP_MEMBERS, LOCKSTEP_STREAMS, LOCKSTEP_FPS = 2, 2, 30.0


def free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def http_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def read_json_line(proc, timeout_s: float) -> dict:
    """The next JSON line a child prints, or SystemExit after
    ``timeout_s``."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = proc.stdout.readline() if ready else ""
    if not line:
        raise SystemExit(f"a load generator printed nothing within "
                         f"{timeout_s} s")
    return json.loads(line)


def _record_matches(record: dict, want) -> bool:
    """A /detections record against one packed [D, 6] row set, by C.3."""
    import numpy as np

    n = int(want[:, 5].sum())
    dets = record["detections"]
    if len(dets) != n:
        return False
    if not n:
        return True
    return bool(np.abs(np.array([d["bbox"] for d in dets]) - want[:n, :4])
                .max() <= 1e-5 and np.abs(np.array(
                    [d["confidence"] for d in dets]) - want[:n, 4]).max()
                <= 5e-5)


def serve_lockstep(device) -> dict:
    """`cluster_launch.py --no-supervise`: two serve processes on the card
    in one gloo group with lockstep dispatch (RFB-320 float32, frozen
    weights, pixels decode, host annotation, buckets 1-16, queue 32, a
    4 ms window), each fed by a load generator of its own: 2 senders x 30
    fps of the synthetic 640x480 JPEGs, a /detections viewer per stream
    and a /face_stream on one, 1 s of warm traffic and then a 10 s window.
    Every published record must equal the plain float32 detector on one
    of the pictures by C.3; each member's NMS launches must equal its
    dispatches."""
    import socket
    import threading

    import numpy as np
    import torch

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit({"compute_mode": mode})
    if "exclusive" in mode.lower():
        raise SystemExit(f"serve_lockstep: the card's compute mode is {mode}"
                         f"; two member processes cannot share it")
    while True:  # http_base + 10 i and + 1 for each member, all free
        base, coord, lock = free_ports(3)
        try:
            for port in (base + 1, base + 10, base + 11):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
            break
        except OSError:
            continue
    http = [base + 10 * i for i in range(LOCKSTEP_MEMBERS)]
    log = tempfile.TemporaryFile()  # the members' output, shown on failure
    t0 = time.perf_counter()
    launcher = subprocess.Popen(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.cluster_launch",
         "--hosts", str(LOCKSTEP_MEMBERS), "--device", device.type,
         "--no-supervise", "--http-base", str(base),
         "--coordinator-port", str(coord), "--lockstep-port", str(lock),
         "--", "--weights", str(WEIGHTS), "--compute-dtype", "float32",
         "--decode-mode", "pixels", "--annotate", "host",
         "--max-batch", "16", "--queue-capacity", "32",
         "--batch-window-ms", "4", "--warmup", "640x480", "--warmup-sync",
         "--link-adaptive", "off"],
        cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)
    gens: list[subprocess.Popen] = []
    try:
        deadline = time.time() + 300
        while True:
            try:
                stats = [http_json(port, "/stats") for port in http]
                if not any(st["warming"] for st in stats):
                    break
            except OSError:
                pass
            if launcher.poll() is not None or time.time() > deadline:
                log.seek(0)
                raise SystemExit("serve_lockstep: the members did not come "
                                 "up; " + log.read().decode(
                                     errors="replace")[-3000:])
            time.sleep(0.5)
        startup_s = time.perf_counter() - t0
        gens = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--load-generator",
             str(port), str(port + 1), str(LOCKSTEP_STREAMS),
             str(LOCKSTEP_FPS), str(SYNTH_PICS)], cwd=str(REPO),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for port in http]

        def send_all(frames: int) -> list[dict]:
            for g in gens:
                g.stdin.write(f"send {frames}\n")
                g.stdin.flush()
            return [read_json_line(g, SERVE_SECONDS + 60) for g in gens]

        def settled(before: list[dict], sent: list[int]) -> list[dict]:
            """/stats of each member once every frame sent since
            ``before`` was served or dropped (the meter drains every 2 s)."""
            deadline = time.time() + 30
            while True:
                now = [http_json(port, "/stats") for port in http]
                done = [n["totals"].get("inferred_unique", 0)
                        + n["totals"].get("dropped", 0)
                        - b["totals"].get("inferred_unique", 0)
                        - b["totals"].get("dropped", 0) >= s
                        for n, b, s in zip(now, before, sent)]
                if all(done) or time.time() > deadline:
                    return now
                time.sleep(0.5)

        zero = [http_json(port, "/stats") for port in http]
        warm = send_all(int(LOCKSTEP_FPS))  # 1 s: the viewers subscribe
        before = settled(zero, [w["sent"] for w in warm])
        windows: list[dict] = [{} for _ in http]
        stop = threading.Event()

        def poll():  # the meter's 2 s windows of each member
            while not stop.is_set():
                for i, port in enumerate(http):
                    try:
                        st = http_json(port, "/stats")
                    except OSError:
                        continue
                    e2e = st.get("stages", {}).get("e2e")
                    if e2e:
                        windows[i][json.dumps(e2e, sort_keys=True)] = e2e
                stop.wait(0.5)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        start = time.perf_counter()
        loads = send_all(int(LOCKSTEP_FPS * SERVE_SECONDS))
        window_s = time.perf_counter() - start
        after = settled(before, [ld["sent"] for ld in loads])
        stop.set()
        poller.join()
        views = []
        for g in gens:
            g.stdin.write("stop\n")
            g.stdin.flush()
            views.append(read_json_line(g, 60))
            g.wait(60)
    finally:
        for g in gens:
            if g.poll() is None:
                g.kill()
        if launcher.poll() is None:
            launcher.send_signal(signal.SIGTERM)
        try:
            launcher.wait(60)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.wait()
        log.close()

    # the plain float32 detector on each picture
    det = Detector(DetectorConfig(compute_dtype="float32"),
                   weights=str(WEIGHTS), device=device)
    pics = [codec.decode_rgb(p.read_bytes())
            for p in sorted(SYNTH_PICS.glob("*.jpg"))]
    refs = [det.run_device(f[None], pack_output=True)[0].cpu().numpy()
            for f in pics]
    torch.cuda.synchronize()
    members = []
    for i in range(LOCKSTEP_MEMBERS):
        b, a = before[i], after[i]
        inferred = (a["totals"].get("inferred_unique", 0)
                    - b["totals"].get("inferred_unique", 0))
        records = [json.loads(line) for lines in views[i]["records"]
                   for line in lines]
        matched = [any(_record_matches(r, ref) for ref in refs)
                   for r in records]
        e2e = list(windows[i].values())
        lb, la = b["lockstep"], a["lockstep"]
        members.append({
            "process": la["process"], "frames_sent": loads[i]["sent"],
            "frames_inferred": inferred,
            "frames_dropped": (a["totals"].get("dropped", 0)
                               - b["totals"].get("dropped", 0)),
            "inferred_fps": inferred / window_s,
            "batches": (a["totals"].get("batches", 0)
                        - b["totals"].get("batches", 0)),
            "e2e_p50_ms_median_of_windows": (
                float(np.median([w["p50_ms"] for w in e2e])) if e2e
                else None),
            "e2e_p99_ms_max_of_windows": (
                max(w["p99_ms"] for w in e2e) if e2e else None),
            "meter_windows": len(e2e),
            "window_dispatches": la["dispatches"] - lb["dispatches"],
            "window_nms_launches": la["nms_launches"] - lb["nms_launches"],
            "dispatches": la["dispatches"], "nms_launches": la["nms_launches"],
            "rounds": la["rounds"],
            "records": len(records), "records_matching_plain": sum(matched),
            "records_per_stream": [len(lines)
                                   for lines in views[i]["records"]],
            "face_parts": views[i]["face_parts"],
            "face_part_shapes": views[i]["face_part_shapes"],
            "topology": a["topology"]})
    return {"members": members, "compute_mode": mode,
            "streams_per_member": LOCKSTEP_STREAMS,
            "fps_per_stream": LOCKSTEP_FPS, "window_s": window_s,
            "startup_s": startup_s,
            "e2e_note": "per member: the median of the meter's 2 s "
                        "windows' p50 and the largest of their p99"}


def check_lockstep(rec: dict) -> None:
    """The lockstep phase's failure conditions."""
    for m in rec["members"]:
        who = f"lockstep member {m['process']}"
        if not m["frames_inferred"] or not min(m["records_per_stream"]):
            raise SystemExit(f"{who} did not serve each of its streams: "
                             f"{m}")
        if m["records_matching_plain"] != m["records"]:
            raise SystemExit(f"{who}: {m['records'] - m['records_matching_plain']}"
                             f" records differ from the plain float32 "
                             f"detector on every picture")
        if (m["nms_launches"] != m["dispatches"]
                or m["window_nms_launches"] != m["window_dispatches"]):
            raise SystemExit(f"{who}: nms launches {m['nms_launches']} "
                             f"({m['window_nms_launches']} in the window) "
                             f"for {m['dispatches']} dispatches "
                             f"({m['window_dispatches']})")
        if not m["face_parts"] or m["face_part_shapes"] != [[480, 640, 3]]:
            raise SystemExit(f"{who}: /face_stream parts "
                             f"{m['face_part_shapes']}")
        if (m["topology"]["processes"], m["topology"]["lockstep"]) != (
                LOCKSTEP_MEMBERS, True):
            raise SystemExit(f"{who}: topology {m['topology']}")
    if rec["members"][0]["rounds"] is None:
        raise SystemExit("member 0 runs no lockstep coordinator")


# -- phase 5h: the serve CLI's throughput preset under the load generator ---

CLI_PRESET = "throughput"


def serve_cli_throughput(device) -> dict:
    """``python -m infercam_onnx_tpu_torch.serve --preset throughput`` (ycbcr
    decode at scale 2, queue 48, buckets 1-16, a 6 ms window, warm-up in the
    background) on the frozen weights, on free ports, as a child process,
    driven by ``python -m infercam_onnx_tpu_torch.loadgen --streams 16
    --fps 30 --seconds 10`` over the synthetic 640x480 JPEGs. The server's
    /stats is read before the load generator starts and once every frame
    it sent was served or dropped (its batch count stops moving); between
    the two, the NMS launches its /stats ``kernels`` counts must equal the
    batches its meter counts."""
    http, sock = free_ports(2)
    log = tempfile.TemporaryFile()  # the server's output, shown on failure
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-m", "infercam_onnx_tpu_torch.serve",
         "--device", device.type, "--preset", CLI_PRESET,
         "--weights", str(WEIGHTS),
         "--server-address", f"127.0.0.1:{http}",
         "--socket-address", f"127.0.0.1:{sock}"],
        cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)

    def fail(why: str):
        log.seek(0)
        raise SystemExit(f"serve_cli_throughput: {why}; server log: "
                         + log.read().decode(errors="replace")[-3000:])

    try:
        deadline = time.time() + 300
        while True:
            try:
                if not http_json(http, "/stats")["warming"]:
                    break
            except OSError:
                pass
            if server.poll() is not None or time.time() > deadline:
                fail("the server did not come up")
            time.sleep(0.5)
        startup_s = time.perf_counter() - t0
        before = http_json(http, "/stats")
        load = subprocess.run(
            [sys.executable, "-m", "infercam_onnx_tpu_torch.loadgen",
             "--server", f"127.0.0.1:{http}", "--socket",
             f"127.0.0.1:{sock}", "--streams", str(SERVE_STREAMS), "--fps",
             str(SERVE_FPS), "--seconds", str(SERVE_SECONDS),
             "--replay-dir", str(SYNTH_PICS)],
            cwd=str(REPO), capture_output=True, text=True, timeout=300)
        if load.returncode:
            fail(f"the load generator failed (rc {load.returncode}): "
                 f"{load.stderr[-2000:]}")
        loadgen = json.loads(load.stdout.strip().splitlines()[-1])
        settled, last = None, None  # /stats once the batch count stops
        deadline = time.time() + 30
        while time.time() < deadline:
            time.sleep(1.0)
            settled = http_json(http, "/stats")
            if last is not None and (settled["totals"].get("batches")
                                     == last["totals"].get("batches")):
                break
            last = settled
        if server.poll() is not None:
            fail("the server exited under load")
    finally:
        if server.poll() is None:
            server.send_signal(signal.SIGTERM)
        try:
            server.wait(60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        log.close()

    def delta(key: str) -> int:
        return (settled["totals"].get(key, 0) - before["totals"].get(key, 0))

    return {"preset": CLI_PRESET, "streams": SERVE_STREAMS,
            "fps_per_stream": SERVE_FPS, "startup_s": startup_s,
            "loadgen": loadgen, "stats_before": before,
            "stats_after": settled,
            "frames_inferred": delta("inferred_unique"),
            "frames_dropped": delta("dropped"), "batches": delta("batches"),
            "nms_launches": (settled["kernels"]["nms_launches"]
                             - before["kernels"]["nms_launches"]),
            "link": settled.get("link")}


def check_serve_cli(rec: dict) -> None:
    if not rec["frames_inferred"] or not rec["loadgen"]["server_inferred_fps"]:
        raise SystemExit("the throughput preset server inferred no frame")
    if rec["loadgen"]["sender_errors"]:
        raise SystemExit(f"{rec['loadgen']['sender_errors']} load generator "
                         f"senders stopped on an error")
    if rec["nms_launches"] != rec["batches"]:
        raise SystemExit(f"the throughput preset server launched nms "
                         f"{rec['nms_launches']} times for {rec['batches']} "
                         f"batches")


TURNS_CODE = """
import json, sys, time, torch
import chip_smoke as cs
cs.build_kernels()
out = {}
for mode in (("pixels", "host"), ("ycbcr", "device")):
    t0 = time.perf_counter()
    r = cs.serve_phase(torch.device("cuda", 0), *mode)
    out["_".join(mode)] = dict({k: r[k] for k in (
        "inferred_fps", "frames_dropped", "e2e_p50_ms", "e2e_p99_ms",
        "mean_batch", "stage_mean_ms")}, phase_s=time.perf_counter() - t0)
print("TURN " + json.dumps(out), flush=True)
"""


def serve_turns(parent: str) -> int:
    """The pixels/host and ycbcr/device serve phases of the checkout at
    ``parent`` (another commit's tree, e.g. unpacked with git archive) and
    of this one, in turns on one card: parent, this, this, parent, each in
    a process of its own. One JSON line a run."""
    trees = {"parent": pathlib.Path(parent).resolve(), "this": REPO}
    for name in ("parent", "this", "this", "parent"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", TURNS_CODE],
                              cwd=trees[name], capture_output=True,
                              text=True, timeout=900)
        lines = [ln[5:] for ln in proc.stdout.splitlines()
                 if ln.startswith("TURN ")]
        emit({"turn": name, "tree": str(trees[name]),
              "rc": proc.returncode, "s": time.perf_counter() - t0,
              "result": json.loads(lines[0]) if lines else None,
              "stderr_tail": proc.stderr[-800:] if proc.returncode else ""})
        if proc.returncode:
            return proc.returncode
    print(gpu_info(), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # without the repository's sources this fails before any output
    import infercam_onnx_tpu_torch  # noqa: F401

    started = time.perf_counter()
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
    if kcheck["cases_not_launched_once"]:
        raise SystemExit("a call of the nms kernel did not launch it once")
    hd = hd_jpegs(16)
    inputs = nms_inputs(device, hd)
    ktime = time_nms(device, inputs)
    for key, rec in ktime.items():
        emit({"phase": "nms_time", "input": key, "gpu": name,
              "power_limit": power, **rec})
    if any(rec["ms"] is None for rec in ktime.values()):
        raise SystemExit("the profiler recorded no nms_kernel device time")
    split = nms_phase_split(device, inputs)
    emit({"phase": "nms_phase_split", "gpu": name, "power_limit": power,
          **split})
    if any(rec["mismatches"] for rec in split.values()):
        raise SystemExit("the stamped nms build disagrees with the plain "
                         "version")

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
    if path["launches"]["nms"] != 1:
        raise SystemExit(f"main path launched the nms kernel "
                         f"{path['launches']['nms']} times, not once")

    jpegs = synthetic_jpegs(16)
    decode = native_decode(jpegs)
    emit({"phase": "native_decode", "gpu": name, "power_limit": power,
          **decode})
    if not all(v["shapes_equal"] for v in decode["vs_pil"].values()):
        raise SystemExit("the shim's decode sizes differ from PIL's")
    ycbcr = ycbcr_path(device, jpegs)
    emit({"phase": "ycbcr_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", "batch": 16, "frame": [640, 480], **ycbcr})
    for scale, rec in ycbcr["by_scale"].items():
        if rec["launches"]["nms"] != 1:
            raise SystemExit(f"the ycbcr path launched the nms kernel "
                             f"{rec['launches']['nms']} times, not once")
        if not rec["sanity"]["ok"]:
            raise SystemExit("ycbcr path output failed its sanity checks")
    # the JAX package's own bar for this comparison
    # (tests/test_jpeg_device.py): its float colour pass lands 1 u8 level
    # off libjpeg's integer one here and there, which moves confidences
    # near the 0.5 threshold (the JAX package's float32 program reaches
    # 0.935 on these frames)
    if ycbcr["by_scale"][1]["parity_vs_pixels"]["box_parity"] < 0.9:
        raise SystemExit("ycbcr detections fell below 0.9 box parity with "
                         "the pixels path")
    f32 = ycbcr["float32_cuda_vs_cpu"]
    if (not f32["counts_equal"] or f32["max_box_diff"] > 1e-5
            or f32["max_conf_diff"] > 5e-5):
        raise SystemExit(f"the float32 ycbcr program on the card differs "
                         f"from the CPU's: {f32}")

    annot = annotate_path(device, jpegs)
    emit({"phase": "annotate_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", "batch": 16, "frame": [640, 480], **annot})
    for prog, rec in annot["by_program"].items():
        check_annotate(rec)
        if not rec["detections_identical_to_detect_only"]:
            raise SystemExit(f"{prog}: its detections differ from the "
                             f"detection-only program's")
        # the JAX package's bar (tests/test_annotate_device.py)
        if max(rec["mad_vs_host_draw_encode"]) >= 4.0:
            raise SystemExit(f"{prog}: an annotated frame is 4 or more levels "
                             f"off the host's draw + encode on average")
        check_card_vs_cpu(annot["float32_cuda_vs_cpu"][prog], prog)
        if any(annot["float32_tf32_moved"][prog].values()):
            raise SystemExit(f"{prog}: the float32 coefficients moved with "
                             f"the process-wide TF32 setting")
    coef = coefficients_path(device, jpegs)
    emit({"phase": "coefficients_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", "batch": 16, "frame": [640, 480], **coef})
    for prog, rec in coef["by_program"].items():
        check_annotate(rec)
        check_card_vs_cpu(coef["float32_cuda_vs_cpu"][prog], prog)
    splice = coef["by_program"]["detect_annotate_splice"]
    if not all(splice["untouched_bit_exact"]):
        raise SystemExit("a block the splice did not touch differs from the "
                         "input's")
    # a frame within the budget ships every block it touched; one over it
    # fills the budget and is flagged (meta[0] > k) for the host fallback,
    # as in the JAX package, whose float32 program overflows 768 on frame
    # 4 of these too
    if splice["selected_blocks"] != [min(t, SPLICE_K)
                                     for t in splice["touched_blocks"]]:
        raise SystemExit(f"the splice's meta is inconsistent: touched "
                         f"{splice['touched_blocks']}, selected "
                         f"{splice['selected_blocks']}")
    if not coef["float32_cuda_vs_cpu"]["detect_annotate_splice"]["meta_equal"]:
        raise SystemExit("the float32 splice selected other blocks on the "
                         "card than on the CPU")
    if (coef["by_program"]["detect_from_coefficients"]["parity_vs_pixels"]
            ["box_parity"] < 0.9):  # the JAX package's bar
        raise SystemExit("coefficients detections fell below 0.9 box parity "
                         "with the pixels path")

    tiled = tiled_path(device, hd)
    emit({"phase": "tiled_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", "batch": len(hd), **tiled})
    check_tiled(tiled)
    probe = link_probe(device)
    emit({"phase": "link_probe", "gpu": name, "power_limit": power, **probe})
    sharded = sharded_path(device, jpegs, hd)
    emit({"phase": "sharded_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", **sharded})
    check_sharded(sharded)
    graph = graph_path(device, jpegs)
    emit({"phase": "graph_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", **graph})
    check_graph(graph)
    qdq = qdq_path(device, jpegs)
    emit({"phase": "qdq_path", "gpu": name, "power_limit": power,
          "variant": "RFB-320", **qdq})
    check_qdq(qdq)
    ops = graph_ops(device)
    emit({"phase": "graph_ops", "gpu": name, "power_limit": power, **ops})
    check_graph_ops(ops)
    new_phases_s = {}
    t0 = time.perf_counter()
    chain = weights_chain(device)
    new_phases_s["weights_chain"] = time.perf_counter() - t0
    emit({"phase": "weights_chain", "gpu": name, "power_limit": power,
          **chain})
    check_weights_chain(chain)
    t0 = time.perf_counter()
    gcli = goldens_cli(device, gold)
    new_phases_s["goldens_cli"] = time.perf_counter() - t0
    emit({"phase": "goldens_cli", "gpu": name, "power_limit": power, **gcli})
    check_goldens_cli(gcli)
    t0 = time.perf_counter()
    runner = onnx_run(device)
    new_phases_s["onnx_run"] = time.perf_counter() - t0
    emit({"phase": "onnx_run", "gpu": name, "power_limit": power, **runner})
    check_onnx_run(runner)
    t0 = time.perf_counter()
    api = model_api(device)
    new_phases_s["model_api"] = time.perf_counter() - t0
    emit({"phase": "model_api", "gpu": name, "power_limit": power,
          "batch": 16, "frame": [640, 480], **api})
    check_model_api(api)

    serves = {}
    for phase, onnx in (("serve_graph", GRAPH_ONNX), ("serve_qdq", QDQ_ONNX)):
        rec = serves[phase] = serve_phase(device, onnx=onnx)
        emit({"phase": phase, "gpu": name, "power_limit": power, **rec})
        check_serve(rec)
        if not rec["checked_batch_kinds"].get("pixels"):
            raise SystemExit(f"no checked batch of the {phase} server took "
                             f"its pixels unit")
    for phase, decode_mode, annotate_mode, unit in (
            ("serve", "pixels", "host", "pixels"),
            ("serve_ycbcr", "ycbcr", "host", "ycbcr"),
            ("serve_ycbcr_annotate", "ycbcr", "device", "ycbcr"),
            ("serve_coefficients", "coefficients", "device", "coef"),
            ("serve_pixels_annotate", "pixels", "device", "pixels")):
        t0 = time.perf_counter()
        rec = serves[phase] = serve_phase(device, decode_mode, annotate_mode)
        if phase == "serve_pixels_annotate":
            new_phases_s[phase] = time.perf_counter() - t0
        emit({"phase": phase, "gpu": name, "power_limit": power, **rec})
        check_serve(rec)
        if not rec["checked_batch_kinds"].get(unit):
            raise SystemExit(f"no checked batch of the {phase} server took "
                             f"its {unit} unit")
    with tempfile.TemporaryDirectory() as pics:
        for i, data in enumerate(hd):
            (pathlib.Path(pics) / f"hd{i:02d}.jpg").write_bytes(data)
        rec = serves["serve_tiled"] = serve_phase(
            device, "ycbcr", "device", streams=TILED_STREAMS, fps=TILED_FPS,
            frame=HD, pics=pathlib.Path(pics),
            tile_min_pixels=TILE_MIN_PIXELS, tile_grid=TILE_GRID,
            tile_overlap=TILE_OVERLAP, tiled_upload="auto")
    emit({"phase": "serve_tiled", "gpu": name, "power_limit": power, **rec})
    check_serve(rec)
    kinds = rec["checked_batch_kinds"]
    if not kinds.get("pixels") or not (kinds.get("ycbcr_tiled")
                                       or kinds.get("ycbcr_tiled_rows")):
        raise SystemExit(f"the tiled server's checked batches took {kinds}, "
                         f"not a pixels and a tiled ycbcr unit")
    lockstep = serve_lockstep(device)
    emit({"phase": "serve_lockstep", "gpu": name, "power_limit": power,
          **lockstep})
    check_lockstep(lockstep)
    t0 = time.perf_counter()
    cli = serve_cli_throughput(device)
    new_phases_s["serve_cli_throughput"] = time.perf_counter() - t0
    emit({"phase": "serve_cli_throughput", "gpu": name, "power_limit": power,
          **cli})
    check_serve_cli(cli)

    # PR 9's final run took 302.5 s (PERF.md section 5)
    emit({"phase": "total", "seconds": time.perf_counter() - started,
          "pr9_seconds": 302.5, "new_phases_s": new_phases_s,
          "new_phases_total_s": sum(new_phases_s.values())})
    head = ktime["a_random_b16_k256"]
    emit({"kernels": [{
        "name": "nms_greedy_suppress", "route": "cuda",
        "source": "infercam_onnx_tpu_torch/csrc/nms.cu",
        "replaces": "infercam_onnx_tpu/ops/pallas/nms.py:45",
        "redesigned": "v2: a thread block cluster per image builds the "
                      "valid-pairs bitmask; the scan resolves 64 candidates "
                      "at a time",
        "launches": path["launches"]["nms"],
        # each path's launches, its count set to 0 just before it
        "launches_by_path": {
            "detect_program": path["launches"]["nms"],
            "detect_from_ycbcr": ycbcr["by_scale"][1]["launches"]["nms"],
            **{prog: rec["launches"]["nms"] for prog, rec in (
                *annot["by_program"].items(), *coef["by_program"].items())},
            **tiled["by_scale"][1]["launches"],
            # two replicas on the card: per replica a call, bfloat16
            **{f"sharded_2x_{prog}": rec["bfloat16"]["launches_two_replicas"]
               for prog, rec in sharded["by_program"].items()},
            **{f"tiled_{mode}_{inp}": n
               for inp, rec in sharded["tiled"]["by_input"].items()
               for mode, n in rec["launches"].items()},
            "graph_detect_program": graph["launches"],
            **{f"graph_{prog}": rec["launches"]
               for prog, rec in graph["by_program"].items()},
            "graph_2x_detect_program": graph["launches_two_replicas"],
            "qdq_detect_program": qdq["launches"],
            **{f"qdq_{prog}": rec["launches"]
               for prog, rec in qdq["by_program"].items()},
            "qdq_2x_detect_program": qdq["launches_two_replicas"],
            **{phase: rec["nms_launches"] for phase, rec in serves.items()},
            "serve_lockstep": sum(m["window_nms_launches"]
                                  for m in lockstep["members"]),
            "weights_chain": chain["launches"],
            "goldens_cli": gcli["launches"],
            "model_api": api["launches"],
            "serve_cli_throughput": cli["nms_launches"]},
        "max_abs_err": kcheck["max_abs_err"],
        "mismatches": kcheck["mismatches"],
        # at input (a), B=16 K=256 random boxes, as in the first version
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "by_input": {key[0]: {f: rec[f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
            for key, rec in ktime.items()}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-turns"]:
        sys.exit(serve_turns(sys.argv[2]))
    if sys.argv[1:2] == ["--load-generator"]:  # the serve phase's child
        import asyncio

        asyncio.run(load_generator(int(sys.argv[2]), int(sys.argv[3]),
                                   int(sys.argv[4]), float(sys.argv[5]),
                                   sys.argv[6]))
        sys.exit(0)
    sys.exit(main())
