"""The hand CUDA kernels against their plain versions, the packed-YCbCr
decode tail, the annotated and coefficient programs against the CPU, the
serving worker's stream-ordered transfers, the tiled programs (one
NMS launch a call, kernel = scan, rows = packed) and two data-parallel
replicas on one card, on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernel at
first use); without one each skips with its reason. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames
from infercam_onnx_tpu_torch.ops import nms
from infercam_onnx_tpu_torch.ops import postprocess as pp

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; none is available")
    return torch.device("cuda", 0)


def _candidates(seed, b, k, device):
    """Clustered corner boxes [B, 4, K] and a random valid mask [B, 1, K]."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1, 0.9, size=(b, 12, 2))
    idx = rng.integers(0, 12, size=(b, k))
    cxy = np.take_along_axis(centers, idx[..., None], axis=1)
    cxy = cxy + rng.normal(0, 0.02, size=(b, k, 2))
    wh = rng.uniform(0.05, 0.2, size=(b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    boxes_t = np.ascontiguousarray(boxes.transpose(0, 2, 1), np.float32)
    valid = (rng.uniform(size=(b, 1, k)) < 0.8).astype(np.float32)
    return (torch.from_numpy(boxes_t).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("b,k", [(16, 256), (4, 512), (3, 300), (2, 2),
                                 (2, 64), (1, 1024), (1, 256), (64, 256),
                                 (16, 1024)])
def test_nms_kernel_bit_identical_to_plain(cuda, b, k):
    boxes_t, valid = _candidates(k, b, k, cuda)
    before = nms.kernel.launches
    got = nms.greedy_suppress(boxes_t, valid, max_iou=0.5)
    want = nms.greedy_suppress_reference(boxes_t, valid, max_iou=0.5)
    torch.cuda.synchronize()
    assert nms.kernel.launches == before + 1
    assert got.shape == (b, 1, k) and got.dtype == torch.float32
    assert torch.equal(got, want)


def _edit_candidates(kind, boxes_t, valid):
    """Valid masks, boxes and thresholds the kernel must take exactly as
    the plain version does; returns max_iou."""
    b, _, k = valid.shape
    if kind == "sparse_prefix":  # a short valid prefix, a few strays after
        valid.zero_()
        valid[:, :, : k // 8] = 1.0
        valid[:, :, k // 8:: 37] = 1.0
    elif kind == "all_invalid":
        valid.zero_()
    elif kind == "nan_boxes":  # NaN coordinates: IoU NaN never suppresses
        boxes_t[:, 1, 3::7] = float("nan")
        boxes_t[:, 2, 0] = float("nan")
    elif kind == "duplicates":  # exact copies: IoU 1 with the later copy
        boxes_t[:, :, k // 2:] = boxes_t[:, :, : k - k // 2]
        boxes_t[:, :, 1:9] = boxes_t[:, :, :1]
    elif kind in ("zero_max_iou", "negative_max_iou"):
        # the kernel decides +-0 intersections without dividing
        boxes_t[:, 2:, 10:20] = boxes_t[:, :2, 10:20]  # zero area
        boxes_t[:, :, 20:30] = 0.0
        return 0.0 if kind == "zero_max_iou" else -0.5
    else:
        raise ValueError(kind)
    return 0.5


@pytest.mark.parametrize("kind", ["sparse_prefix", "all_invalid",
                                  "nan_boxes", "duplicates", "zero_max_iou",
                                  "negative_max_iou"])
@pytest.mark.parametrize("b,k", [(1, 256), (16, 256), (64, 256),
                                 (16, 1024)])
def test_nms_kernel_edge_inputs_bit_identical(cuda, kind, b, k):
    boxes_t, valid = _candidates(b * k, b, k, cuda)
    max_iou = _edit_candidates(kind, boxes_t, valid)
    before = nms.kernel.launches
    got = nms.greedy_suppress(boxes_t, valid, max_iou=max_iou)
    want = nms.greedy_suppress_reference(boxes_t, valid, max_iou=max_iou)
    torch.cuda.synchronize()
    assert nms.kernel.launches == before + 1
    assert torch.equal(got, want)
    if kind == "all_invalid":
        assert int(got.sum()) == 0


@pytest.mark.parametrize("b,cluster", [(1, 8), (16, 8), (64, 2)])
def test_nms_kernel_clusters_fit_at_k1024(cuda, b, cluster):
    """B * cluster fills the SMs (at most 8 a cluster), and the shared
    memory each CTA takes at K=1024 still lets such clusters be resident."""
    plan = nms.kernel.cluster_plan(b, 1024)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert plan["cluster"] == cluster
    assert 1 <= plan["cluster"] <= 8
    assert plan["active_clusters"] >= 1
    assert plan["smem_bytes"] <= 227 * 1024


def test_nms_kernel_refuses_bad_input(cuda):
    boxes_t, valid = _candidates(0, 2, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        nms.kernel(boxes_t.double(), valid, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        nms.kernel(boxes_t.transpose(0, 1).contiguous().transpose(0, 1),
                   valid, 0.5)
    big, big_valid = _candidates(0, 1, 1025, cuda)
    with pytest.raises(ValueError, match="limit"):
        nms.kernel(big, big_valid, 0.5)


@pytest.mark.parametrize("impl", ["kernel", "xla", "scan"])
def test_batched_nms_on_cuda_matches_cpu(cuda, impl):
    rng = np.random.default_rng(5)
    boxes_t, _ = _candidates(5, 4, 4420, "cpu")
    boxes = boxes_t.transpose(1, 2).contiguous()
    conf = torch.from_numpy(
        (rng.integers(0, 8, size=(4, 4420)) / 8).astype(np.float32))
    want = pp.batched_nms(conf, boxes, top_k=256, impl="scan")
    got = pp.batched_nms(conf.to(cuda), boxes.to(cuda), top_k=256,
                         impl=impl)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_detector_on_cuda_matches_cpu_f32(cuda):
    """float32 trunk, frozen weights, the synthetic pictures, with TF32
    turned on for the whole process: the detector runs in IEEE float32
    all the same, so the card's packed output equals the CPU's in counts,
    and within 1e-4 in values (cuDNN and oneDNN sum the convs in
    different orders)."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "tf32"
    try:
        frames = np.stack(list(load_directory_frames(
            str(REPO / "resources" / "test_pics_synthetic")).values()))
        weights = str(REPO / "resources" / "weights" / "ultraface-twin.npz")
        config = DetectorConfig(compute_dtype="float32", top_k=512,
                                max_detections=256)
        got = Detector(config, weights=weights, device=cuda).run_device(
            frames, pack_output=True).cpu()
        want = Detector(config, weights=weights, device="cpu").run_device(
            frames, pack_output=True)
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
    assert torch.equal(got[..., 5], want[..., 5])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# -- the serving worker's transfers -----------------------------------------


def _burst_jpegs(n: int) -> list[bytes]:
    """n JPEGs of the synthetic pictures, plain and mirrored, in turn."""
    from infercam_onnx_tpu_torch import codec

    pics = list(load_directory_frames(
        str(REPO / "resources" / "test_pics_synthetic")).values())
    frames = pics + [np.ascontiguousarray(p[:, ::-1]) for p in pics]
    jpegs = [codec.encode_rgb(f) for f in frames]
    return [jpegs[i % len(jpegs)] for i in range(n)]


# clock cycles the card spins after each served batch's program: about
# 20 ms, far longer than the host takes from the readback's enqueue to the
# publish stage's first read
LAG_CYCLES = 40_000_000


def _serve_burst(det, jpegs, *, publish_delay_s: float,
                 decode_mode: str = "pixels"):
    """Submit every JPEG at once to an InferenceWorker (no coalescing,
    buckets up to 16, detection-only jobs) and run it until all are
    published. Returns the
    worker, the device units it dispatched with their frame counts,
    whether each batch's readback landed in pinned memory, the NDJSON
    records a /detections subscriber received (in publish order, which is
    dispatch order), and the most batches that were between upload and
    publish at once. ``publish_delay_s`` holds each publish back, so
    uploads and dispatches run ahead of it. The card is held back after
    each batch's program, before its readback (``LAG_CYCLES``): a publish
    stage that read the pinned output before the readback's event would
    read a buffer the copy has not filled yet."""
    import asyncio
    import time

    from infercam_onnx_tpu_torch.config import EngineConfig
    from infercam_onnx_tpu_torch.serving.broadcast import Broadcast
    from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker
    from infercam_onnx_tpu_torch.serving.router import InferJob

    batches, pinned, records, inflight = [], [], [], [0, 0]

    async def run():
        worker = InferenceWorker(det, EngineConfig(
            batch_buckets=(1, 2, 4, 8, 16), queue_capacity=len(jpegs),
            batch_window_ms=20.0, coalesce_streams=False,
            decode_mode=decode_mode))
        decode, dispatch = worker._decode, worker._device_stage
        publish = worker._publish_results

        def decode_tap(jobs):
            units = decode(jobs)
            inflight[0] += len(units)
            inflight[1] = max(inflight)
            return units

        def dispatch_tap(units):
            batches.extend((u, u["n"]) for u in units)
            return dispatch(units)

        def publish_tap(results):
            time.sleep(publish_delay_s)
            pinned.extend(e["packed"].is_pinned() for e in results)
            publish(results)
            inflight[0] -= len(results)

        worker._decode, worker._device_stage = decode_tap, dispatch_tap
        worker._publish_results = publish_tap
        chan = Broadcast(capacity=len(jpegs))  # the test reads every record
        sub = chan.subscribe()
        task = asyncio.ensure_future(worker.run())
        for i, data in enumerate(jpegs):
            assert worker.submit(InferJob(i, data, None, chan))
        for _ in jpegs:  # one NDJSON record per frame
            records.append(json.loads(
                await asyncio.wait_for(sub.receive(), 60)))
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        worker.close()
        return worker

    def lagging(program):
        def run(*args, **kwargs):
            out = program(*args, **kwargs)
            torch.cuda._sleep(LAG_CYCLES)  # on the worker's compute stream
            return out
        return run

    det.run_device = lagging(det.run_device)
    det.run_device_ycbcr_packed = lagging(det.run_device_ycbcr_packed)
    try:
        worker = asyncio.run(run())
    finally:
        del det.run_device, det.run_device_ycbcr_packed
    torch.cuda.synchronize()
    return worker, batches, pinned, records, inflight[1]


def _detections(packed_row: np.ndarray) -> list[dict]:
    """The "detections" of the NDJSON record of one packed output row."""
    return [{"bbox": [float(v) for v in packed_row[d, :4]],
             "confidence": float(packed_row[d, 4])}
            for d in range(int(packed_row[:, 5].sum()))]


@pytest.mark.parametrize("n, publish_delay_s", [(5, 0.0), (64, 0.2)])
def test_served_output_bit_identical_to_run_device(cuda, n, publish_delay_s):
    """The detections the worker published for each frame (pinned upload
    on its copy stream, compute stream, non-blocking readback read after
    its event) are run_device's on the same padded batch outside the
    worker, bit for bit: one small batch, and a burst of four batches of
    16 with the publish stage held back so that at least three are in
    flight at once."""
    det = Detector(weights=str(REPO / "resources" / "weights" /
                               "ultraface-twin.npz"), device=cuda)
    det.warmup(16, 480, 640)
    worker, batches, pinned, records, most_inflight = _serve_burst(
        det, _burst_jpegs(n), publish_delay_s=publish_delay_s)
    assert len(batches) == len(pinned) == (1 if n == 5 else 4)
    assert all(pinned)
    if n == 64:
        assert most_inflight >= 3
    assert sum(count for _, count in batches) == len(records) == n
    row = 0
    for unit, count in batches:
        batch = unit["batch"]
        assert unit["geom"] is None
        assert batch.device == cuda and batch.dtype == torch.uint8
        want = det.run_device(batch, pack_output=True).cpu().numpy()
        served = [r["detections"] for r in records[row:row + count]]
        assert served == [_detections(want[i]) for i in range(count)]
        assert any(served)
        row += count


def test_nms_kernel_runs_on_the_workers_compute_stream(cuda, monkeypatch):
    """Every NMS launch of the served batches is on the worker's compute
    stream, not the default stream."""
    det = Detector(weights=str(REPO / "resources" / "weights" /
                               "ultraface-twin.npz"), device=cuda)
    det.warmup(16, 480, 640)
    real, streams = nms.kernel, []

    def spy(boxes_t, valid, max_iou):
        streams.append(torch.cuda.current_stream())
        return real(boxes_t, valid, max_iou)

    monkeypatch.setattr(nms, "kernel", spy)
    worker, batches, _, _, _ = _serve_burst(det, _burst_jpegs(20),
                                            publish_delay_s=0.0)
    assert len(streams) == len(batches) >= 2
    assert all(s == worker._compute_stream for s in streams)
    assert worker._compute_stream != torch.cuda.default_stream(cuda)


# -- the packed-YCbCr decode tail ---------------------------------------------


def _synthetic_jpegs() -> list[bytes]:
    return [p.read_bytes() for p in sorted(
        (REPO / "resources" / "test_pics_synthetic").glob("*.jpg"))]


@pytest.mark.parametrize("sub", ["420", "422", "444"])
@pytest.mark.parametrize("scale", [1, 2])
def test_combine_ycbcr_on_cuda_matches_cpu(cuda, sub, scale):
    """The upsample products take exact taps and the colour pass runs op
    by op, so the card's RGB equals the CPU's bit for bit."""
    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops import jpeg_device as jd

    frames = codec.decode_batch(_synthetic_jpegs())
    packed, geom = native_jpeg.load().decode_ycbcr_batch(
        [codec.encode_rgb(f, 90, sub) for f in frames], scale=scale)
    keys = ("y_pw", "y_ph", "c_pw", "c_ph")
    packed = torch.from_numpy(np.array(packed))
    out = []
    for device in (cuda, "cpu"):
        planes = jd.unpack_ycbcr_planes(packed.to(device),
                                        **{k: geom[k] for k in keys})
        out.append(jd.combine_ycbcr(
            *planes, width=geom["width"], height=geom["height"],
            sampling=geom["sampling"]).cpu())
    assert torch.equal(*out)


def test_run_device_ycbcr_packed_on_cuda_matches_cpu_f32(cuda):
    """float32 trunk, frozen weights, the synthetic pictures' packed
    planes: the card's packed output equals the CPU's in counts, boxes
    within 1e-5 and confidences within 5e-5 (cuDNN and oneDNN sum the
    convs in different orders), and the program launches the NMS kernel
    once."""
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg

    packed, geom = native_jpeg.load().decode_ycbcr_batch(_synthetic_jpegs())
    weights = str(REPO / "resources" / "weights" / "ultraface-twin.npz")
    config = DetectorConfig(compute_dtype="float32", top_k=512,
                            max_detections=256)
    det = Detector(config, weights=weights, device=cuda)
    before = nms.kernel.launches
    got = det.run_device_ycbcr_packed(packed, geom, pack_output=True).cpu()
    assert nms.kernel.launches == before + 1
    want = Detector(config, weights=weights, device="cpu"
                    ).run_device_ycbcr_packed(packed, geom, pack_output=True)
    assert torch.equal(got[..., 5], want[..., 5])
    assert int(want[..., 5].sum()) >= 10
    torch.testing.assert_close(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got[..., 4], want[..., 4], rtol=0, atol=5e-5)


def test_served_ycbcr_output_bit_identical_to_run_device_ycbcr_packed(cuda):
    """A burst of 64 detection-only frames through a ycbcr worker: each
    dispatched unit holds packed plane rows, and the detections published
    for each frame are run_device_ycbcr_packed's on the same padded batch
    outside the worker, bit for bit, with the card held back before each
    readback."""
    det = Detector(weights=str(REPO / "resources" / "weights" /
                               "ultraface-twin.npz"), device=cuda)
    worker, units, pinned, records, most_inflight = _serve_burst(
        det, _burst_jpegs(64), publish_delay_s=0.2, decode_mode="ycbcr")
    assert len(units) == len(pinned) == 4 and all(pinned)
    assert most_inflight >= 3
    assert sum(count for _, count in units) == len(records) == 64
    row = 0
    for unit, count in units:
        batch, geom = unit["batch"], unit["geom"]
        assert geom is not None and batch.ndim == 2
        assert batch.device == cuda and batch.dtype == torch.uint8
        want = det.run_device_ycbcr_packed(batch, geom,
                                           pack_output=True).cpu().numpy()
        served = [r["detections"] for r in records[row:row + count]]
        assert served == [_detections(want[i]) for i in range(count)]
        assert any(served)
        row += count


def test_nms_kernel_runs_on_the_ycbcr_workers_compute_stream(cuda,
                                                             monkeypatch):
    det = Detector(weights=str(REPO / "resources" / "weights" /
                               "ultraface-twin.npz"), device=cuda)
    real, streams = nms.kernel, []

    def spy(boxes_t, valid, max_iou):
        streams.append(torch.cuda.current_stream())
        return real(boxes_t, valid, max_iou)

    monkeypatch.setattr(nms, "kernel", spy)
    worker, units, _, _, _ = _serve_burst(det, _burst_jpegs(20),
                                          publish_delay_s=0.0,
                                          decode_mode="ycbcr")
    assert len(streams) == len(units) >= 2
    assert all(u["geom"] is not None for u, _ in units)
    assert all(s == worker._compute_stream for s in streams)


# -- the device annotate tail and the coefficients mode ------------------------


def _program_outputs(det, program: str, jpegs: list[bytes]):
    """The outputs of one annotated or coefficient program of ``det`` on
    ``jpegs``, packed detections last, each a CPU tensor."""
    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch

    if program == "detect_annotate":
        outs = det.run_device_annotated(np.stack(codec.decode_batch(jpegs)))
    elif program == "detect_annotate_from_ycbcr":
        outs = det.run_device_ycbcr_annotated(
            *native_jpeg.load().decode_ycbcr_batch(jpegs))
    else:
        y, cb, cr, quant, wh, samp = read_coefficient_batch(jpegs)
        if program == "detect_from_coefficients":
            outs = (det.run_device_coefficients_arrays(
                y, cb, cr, quant, wh, sampling=samp, pack_output=True),)
        else:
            outs = det.run_device_coefficients_annotated(
                y, cb, cr, quant, wh, sampling=samp, k=768)
    return [t.cpu() for t in outs]


@pytest.mark.parametrize("program", [
    "detect_annotate", "detect_annotate_from_ycbcr",
    "detect_from_coefficients", "detect_annotate_splice"])
def test_annotate_and_coefficient_programs_on_cuda_match_cpu(cuda, program):
    """float32, frozen weights, the synthetic pictures: the card's packed
    detections equal the CPU's in counts, boxes within 1e-5 and
    confidences within 5e-5; its quantized coefficients (or the splice's
    blocks) equal the CPU's in >= 99.9% of entries and never differ by
    more than 1, the splice's block choice is the CPU's, TF32 switched on
    for the whole process moves none of it, and the program launches the
    NMS kernel once."""
    from infercam_onnx_tpu_torch.ops.jpeg_encode_device import unpack12

    jpegs = _synthetic_jpegs()
    weights = str(REPO / "resources" / "weights" / "ultraface-twin.npz")
    config = DetectorConfig(compute_dtype="float32")
    det = Detector(config, weights=weights, device=cuda)
    before = nms.kernel.launches
    got = _program_outputs(det, program, jpegs)
    assert nms.kernel.launches == before + 1
    want = _program_outputs(Detector(config, weights=weights, device="cpu"),
                            program, jpegs)
    assert torch.equal(got[-1][..., 5], want[-1][..., 5])
    assert int(want[-1][..., 5].sum()) >= 10
    torch.testing.assert_close(got[-1][..., :4], want[-1][..., :4], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got[-1][..., 4], want[-1][..., 4], rtol=0,
                               atol=5e-5)
    if program == "detect_annotate_splice":
        assert torch.equal(got[1], want[1])
    if len(got) > 1:
        g, w = (np.stack([unpack12(r) for r in t[0].numpy()]).astype(np.int32)
                for t in (got, want))
        assert (g == w).mean() >= 0.999
        assert np.abs(g - w).max() <= 1
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "tf32"
    try:
        tf32 = _program_outputs(det, program, jpegs)
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
    assert all(torch.equal(a, b) for a, b in zip(tf32, got))


# -- tiled high-resolution detection ------------------------------------------


def _hd_jpegs(width: int, height: int, n: int = 4) -> list[bytes]:
    """n quality-90 4:2:0 JPEGs of the synthetic pictures, plain and
    mirrored, resized to width x height."""
    from infercam_onnx_tpu_torch import codec

    pics = list(load_directory_frames(
        str(REPO / "resources" / "test_pics_synthetic"),
        resize=(width, height)).values())
    frames = pics + [np.ascontiguousarray(p[:, ::-1]) for p in pics]
    return [codec.encode_rgb(frames[i % len(frames)], 90, "420")
            for i in range(n)]


@pytest.mark.parametrize("size", [(1920, 1080), (960, 540)])
def test_tiled_programs_kernel_equals_scan_and_rows_equal_packed(cuda, size):
    """RFB-320 bf16 on the frozen weights, a 2x2 grid: each tiled program
    launches the NMS kernel once, its packed output equals the same
    program with the plain scan bit for bit, and the rows program (one
    device tensor a frame) equals the packed one bit for bit."""
    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
    from infercam_onnx_tpu_torch.parallel import tiling

    jpegs = _hd_jpegs(*size)
    det = Detector(weights=str(REPO / "resources" / "weights" /
                               "ultraface-twin.npz"), device=cuda)
    tiled = tiling.TiledDetector(det, size, grid=(2, 2), overlap=0.2)
    frames = torch.from_numpy(np.stack(codec.decode_batch(jpegs))).to(cuda)
    packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs)
    packed_dev = torch.from_numpy(np.array(packed)).to(cuda)
    rows = [torch.from_numpy(np.array(r)).to(cuda) for r in packed]
    kw = dict(tiles=tiled.tiles, **det._thresholds())
    r_h, r_w = tiled._r_h, tiled._r_w
    geo = {k: geom[k] for k in ("width", "height", "y_pw", "y_ph", "c_pw",
                                "c_ph")}
    outs = {}
    for name, call in (
            ("pixels", lambda: tiled.run_device(frames, pack_output=True)),
            ("ycbcr", lambda: tiled.run_device_ycbcr_packed(
                packed_dev, geom, pack_output=True)),
            ("rows", lambda: tiled.run_device_ycbcr_rows(
                rows, geom, pack_output=True))):
        before = nms.kernel.launches
        outs[name] = call()
        torch.cuda.synchronize()
        assert nms.kernel.launches == before + 1, name
    scan_pixels = tiling.tiled_detect_program(
        det.model, det.priors, frames, r_h, r_w, pack_output=True,
        nms_impl="scan", **kw)
    scan_ycbcr = tiling.tiled_detect_from_ycbcr_program(
        det.model, det.priors, packed_dev, r_h, r_w, pack_output=True,
        nms_impl="scan", sampling=tuple(geom["sampling"]), **geo, **kw)
    assert torch.equal(outs["pixels"], scan_pixels)
    assert torch.equal(outs["ycbcr"], scan_ycbcr)
    assert torch.equal(outs["rows"], outs["ycbcr"])
    assert int(outs["pixels"][..., 5].sum()) >= 4


@pytest.mark.parametrize("host_input", [False, True])
def test_sharded_detector_on_one_card_matches_each_shard(cuda, host_input):
    """Two replicas on one card (four streams): each replica's rows are
    bit-identical to the plain detector on them alone, the result lands
    on the first device, and NMS launches once a replica. Host input
    goes up through pinned memory on each replica's copy stream."""
    from infercam_onnx_tpu_torch.parallel import ShardedDetector

    det = Detector(DetectorConfig(compute_dtype="float32"), device=cuda)
    frames = np.stack(list(load_directory_frames(
        str(REPO / "resources" / "test_pics_synthetic"),
        resize=(640, 480)).values()))
    x = frames if host_input else torch.from_numpy(frames).to(cuda)
    sharded = ShardedDetector(det, [cuda, cuda])
    want = torch.cat([det.run_device(x[i:i + 2], pack_output=True)
                      for i in (0, 2)])
    before = nms.kernel.launches
    got = sharded.run_device(x, pack_output=True)
    torch.cuda.synchronize()
    assert nms.kernel.launches == before + 2
    assert got.device == torch.device("cuda", 0)
    assert torch.equal(got, want)
    # an odd batch pads on the card and slices back
    got3 = sharded.run_device(x[:3], pack_output=True)
    assert got3.shape[0] == 3
    assert torch.equal(got3[:2], want[:2])


def test_mesh_worker_reads_back_every_replica(cuda):
    """The worker on a two-entry mesh hands the pinned batch to the
    sharded detector; its readback on the compute stream covers both
    replicas' rows."""
    from infercam_onnx_tpu_torch.config import EngineConfig
    from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker

    det = Detector(DetectorConfig(compute_dtype="float32"), device=cuda)
    worker = InferenceWorker(det, EngineConfig(batch_buckets=(1, 2, 4),
                                               annotate_mode="host",
                                               link_adaptive=False),
                             mesh=[cuda, cuda])
    try:
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 256, (3, 240, 320, 3), dtype=np.uint8)
        unit = worker._unit("pixels", [(None, f) for f in frames])
        assert unit["ready"] is None and unit["batch"].is_pinned()
        assert unit["batch"].shape[0] == 4  # the mesh multiple
        outs, done = worker._device_exec.submit(worker._run_unit,
                                                unit).result()
        done.synchronize()
        batch = unit["batch"].to(cuda)
        want = torch.cat([det.run_device(batch[i:i + 2], pack_output=True)
                          for i in (0, 2)])
        assert torch.equal(outs[-1], want.cpu())
    finally:
        worker.close()
