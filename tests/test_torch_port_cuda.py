"""The hand CUDA kernels against their plain versions, the packed-YCbCr
decode tail, the annotated and coefficient programs against the CPU, the
serving worker's stream-ordered transfers, the ycbcr program replayed
from the CUDA graphs a worker's warm-up captured (bit-identical to the
eager program), the tiled programs (one
NMS launch a call, kernel = scan, rows = packed) and two data-parallel
replicas on one card, the ONNX graph detector (float and int8 QDQ), the
integer quantized ops and control flow under vmap, and the model-level
API (``UltraFace.create(...)(x)`` -> ``ops.batched_postprocess``), on the
card.

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
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

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
                 decode_mode: str = "pixels", warm: bool = False):
    """Submit every JPEG at once to an InferenceWorker (no coalescing,
    buckets up to 16, detection-only jobs) and run it until all are
    published; with ``warm``, after the worker's warm-up at 640x480 on its
    device thread, as the server runs it. Returns the
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
        if warm:
            await asyncio.get_running_loop().run_in_executor(
                worker._device_exec, worker.warmup, [(480, 640)])
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
        nms_impl="scan", geom_key=tiling.geometry_key(geom), **kw)
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


# -- the ycbcr program replayed from CUDA graphs --------------------------------

# the benchmark cells' deployments of each variant: (decode scale of the
# 640x480 cameras, batch buckets)
GRAPH_CELLS = {"RFB-320": (2, (1, 2, 4, 8, 16, 32)),
               "RFB-640": (1, (1, 2, 4, 8, 16, 24))}
_GRAPH_DETECTORS: dict = {}


def _graph_detector(variant: str, cuda) -> Detector:
    """A bfloat16 detector of ``variant`` (seeded random weights), its
    graphs captured by a ycbcr worker's warm-up at 640x480 at the cell's
    decode scale and buckets; built once a module."""
    from infercam_onnx_tpu_torch.config import EngineConfig
    from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker

    if variant not in _GRAPH_DETECTORS:
        scale, buckets = GRAPH_CELLS[variant]
        det = Detector(DetectorConfig(variant=variant), device=cuda)
        worker = InferenceWorker(det, EngineConfig(
            batch_buckets=buckets, decode_mode="ycbcr", decode_scale=scale,
            annotate_mode="host", link_adaptive=False))
        try:
            worker._device_exec.submit(worker.warmup, [(480, 640)]).result()
        finally:
            worker.close()
        _GRAPH_DETECTORS[variant] = det
    return _GRAPH_DETECTORS[variant]


def _packed_batch(jpegs: list[bytes], scale: int, cuda):
    """The JPEGs' packed planes on the card, and their geometry."""
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg

    packed, geom = native_jpeg.load().decode_ycbcr_batch(jpegs, scale=scale)
    return torch.from_numpy(np.array(packed)).to(cuda), geom


def _eager_ycbcr(det: Detector, packed: torch.Tensor, geom: dict):
    """The packed ycbcr program launched op by op (`detect_from_ycbcr`)."""
    from infercam_onnx_tpu_torch.detector import detect_from_ycbcr

    w, h = geom["width"], geom["height"]
    return detect_from_ycbcr(
        det.model, det.priors, packed, *det.preprocessor.matrices(w, h),
        width=w, height=h, y_pw=geom["y_pw"], y_ph=geom["y_ph"],
        c_pw=geom["c_pw"], c_ph=geom["c_ph"],
        sampling=tuple(geom["sampling"]), pack_output=True,
        **det._thresholds())


@pytest.mark.parametrize("variant", sorted(GRAPH_CELLS))
def test_replayed_ycbcr_program_equals_eager_at_every_bucket(cuda, variant):
    """At each bucket of the cell, a full batch of the synthetic pictures:
    the replayed packed detections equal the eager program's bit for bit,
    and each replay adds one to the graphs' replays and one NMS launch."""
    det = _graph_detector(variant, cuda)
    scale, buckets = GRAPH_CELLS[variant]
    assert det.graphs.captures == len(buckets)
    jpegs = _burst_jpegs(max(buckets))
    found = 0
    for b in buckets:
        batch, geom = _packed_batch(jpegs[:b], scale, cuda)
        launches, replays = nms.kernel.launches, det.graphs.replays
        got = det.run_device_ycbcr_packed(batch, geom, pack_output=True)
        assert nms.kernel.launches == launches + 1
        assert det.graphs.replays == replays + 1
        want = _eager_ycbcr(det, batch, geom)
        assert got.shape == want.shape == (b, 64, 6)
        assert torch.equal(got, want), b
        found += int(want[..., 5].sum())
    assert found > 0


@pytest.mark.parametrize("variant", sorted(GRAPH_CELLS))
def test_batches_replayed_in_turn_each_get_their_own_answer(cuda, variant):
    """Two different batches of one bucket replayed in turn, with no wait
    between: each output equals its own batch's eager program, and each
    is a tensor of its own, not the graphs' static output."""
    det = _graph_detector(variant, cuda)
    scale, _ = GRAPH_CELLS[variant]
    jpegs = _burst_jpegs(8)
    one, geom = _packed_batch(jpegs, scale, cuda)
    two, _ = _packed_batch(jpegs[::-1], scale, cuda)
    replays = det.graphs.replays
    got = [det.run_device_ycbcr_packed(b, geom, pack_output=True)
           for b in (one, two, one)]
    assert det.graphs.replays == replays + 3
    want_one, want_two = (_eager_ycbcr(det, b, geom) for b in (one, two))
    assert not torch.equal(want_one, want_two)
    assert torch.equal(got[0], want_one) and torch.equal(got[2], want_one)
    assert torch.equal(got[1], want_two)
    assert len({t.data_ptr() for t in got}) == 3


def test_a_geometry_or_bucket_never_warmed_runs_eager(cuda):
    """The RFB-320 detector was warmed at 320x240 4:2:0 (640x480 at scale
    2): 640x480 at scale 1, a 4:4:4 stream and a batch of 3 (no bucket)
    launch eagerly, one NMS launch each and no replay."""
    from infercam_onnx_tpu_torch import codec

    det = _graph_detector("RFB-320", cuda)
    frames = codec.decode_batch(_burst_jpegs(4))
    cases = [(_burst_jpegs(4), 1),
             ([codec.encode_rgb(f, 90, "444") for f in frames], 2),
             (_burst_jpegs(3), 2)]
    for jpegs, scale in cases:
        batch, geom = _packed_batch(jpegs, scale, cuda)
        launches, replays = nms.kernel.launches, det.graphs.replays
        got = det.run_device_ycbcr_packed(batch, geom, pack_output=True)
        assert nms.kernel.launches == launches + 1
        assert det.graphs.replays == replays
        assert torch.equal(got, _eager_ycbcr(det, batch, geom))


def test_a_warmed_ycbcr_worker_serves_replays_bit_identical_to_eager(cuda):
    """A ycbcr worker warmed on its device thread: every unit of a burst
    of 64 replays (the Meter's ``graph_replays`` counts each), and the
    detections published for each frame are the eager program's on the
    same padded batch, bit for bit, with the card held back before each
    readback."""
    from infercam_onnx_tpu_torch.serving.meter import METER

    det = Detector(weights=str(REPO / "resources" / "weights" /
                               "ultraface-twin.npz"), device=cuda)
    METER.drain()
    base = dict(METER.totals)
    launches = nms.kernel.launches
    worker, units, pinned, records, _ = _serve_burst(
        det, _burst_jpegs(64), publish_delay_s=0.0, decode_mode="ycbcr",
        warm=True)
    METER.drain()
    assert det.graphs.captures == 5  # buckets 1, 2, 4, 8, 16
    assert det.graphs.replays == len(units) == 4 and all(pinned)
    for name, want in (("graph_captures", 5), ("graph_replays", 4)):
        assert METER.totals[name] - base.get(name, 0) == want, name
    # the warm-up's eager runs (pixels, annotated, ycbcr; the capture's own
    # side-stream run) and one a unit
    assert nms.kernel.launches - launches == 5 * 4 + 4
    row = 0
    for unit, count in units:
        want = _eager_ycbcr(det, unit["batch"], unit["geom"]).cpu().numpy()
        served = [r["detections"] for r in records[row:row + count]]
        assert served == [_detections(want[i]) for i in range(count)]
        assert any(served)
        row += count


# -- the ONNX graph runtime ---------------------------------------------------

GRAPH_ONNX = REPO / "tests" / "fixtures" / "ultraface_twin_rfb320.onnx"


def _graph_frames() -> np.ndarray:
    """The four synthetic pictures, plain and mirrored, at 640x480."""
    pics = list(load_directory_frames(
        str(REPO / "resources" / "test_pics_synthetic"),
        resize=(640, 480)).values())
    return np.ascontiguousarray(np.stack(pics + [p[:, ::-1] for p in pics]))


def test_graph_detector_on_cuda_matches_cpu(cuda):
    """GraphDetector on the committed export, TF32 turned on for the whole
    process: card = CPU by ROADMAP C.3 (counts equal, boxes within 1e-5,
    confidences within 5e-5)."""
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "tf32"
    try:
        frames = _graph_frames()
        got = GraphDetector(str(GRAPH_ONNX), device=cuda).run_device(
            frames, pack_output=True).cpu()
        want = GraphDetector(str(GRAPH_ONNX), device="cpu").run_device(
            frames, pack_output=True)
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
    assert torch.equal(got[..., 5], want[..., 5])
    torch.testing.assert_close(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got[..., 4], want[..., 4], rtol=0, atol=5e-5)


def test_graph_detector_launches_the_nms_kernel_once_a_call(cuda):
    """One NMS launch a call of every program, and run_device equal to the
    same program with the plain scan bit for bit."""
    from infercam_onnx_tpu_torch.detector import detect_program
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

    det = GraphDetector(str(GRAPH_ONNX), device=cuda)
    frames = torch.from_numpy(_graph_frames()).to(cuda)
    det.run_device(frames, pack_output=True)
    torch.cuda.synchronize()
    before = nms.kernel.launches
    got = det.run_device(frames, pack_output=True)
    torch.cuda.synchronize()
    assert nms.kernel.launches == before + 1
    r_h, r_w = det.preprocessor.matrices(640, 480)
    plain = detect_program(det.model, det.priors, frames, r_h, r_w,
                           pack_output=True, nms_impl="scan",
                           **det._thresholds())
    assert torch.equal(got, plain)
    before = nms.kernel.launches
    det.run_device_annotated(frames)
    torch.cuda.synchronize()
    assert nms.kernel.launches == before + 1


def test_graph_detector_to_mesh_bit_identical_per_shard(cuda):
    """to_mesh over [cuda:0, cuda:0]: two replicas, each shard's rows
    bit-identical to the plain graph detector on them, two NMS launches a
    call."""
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

    det = GraphDetector(str(GRAPH_ONNX), device=cuda)
    two = det.to_mesh([cuda, cuda])
    assert not hasattr(two, "run_device_coefficients_annotated")
    frames = torch.from_numpy(_graph_frames()).to(cuda)
    want = torch.cat([det.run_device(frames[r], pack_output=True)
                      for r in (slice(0, 4), slice(4, 8))])
    torch.cuda.synchronize()
    before = nms.kernel.launches
    got = two.run_device(frames, pack_output=True)
    torch.cuda.synchronize()
    assert nms.kernel.launches == before + 2
    assert torch.equal(got, want)


# -- the rest of the graph runtime: the QDQ detector, integer ops, control -

QDQ_ONNX = REPO / "tests" / "fixtures" / "ultraface_twin_rfb320_qdq.onnx"


def test_qdq_graph_detector_on_cuda_matches_cpu(cuda):
    """GraphDetector on the committed int8 QDQ export, TF32 turned on for
    the whole process: card against CPU by `chip_smoke.qdq_agreement` (the
    CPU tests' bar for two runs whose float32 sums differ in order), one
    NMS launch a call, nothing copied from the host."""
    from chip_smoke import qdq_agreement
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "tf32"
    try:
        frames = _graph_frames()
        det = GraphDetector(str(QDQ_ONNX), device=cuda)
        det.run_device(frames, pack_output=True)
        torch.cuda.synchronize()
        before = nms.kernel.launches
        got = det.run_device(frames, pack_output=True).cpu()
        assert nms.kernel.launches == before + 1
        assert det.executor.host_copies == 0
        want = GraphDetector(str(QDQ_ONNX), device="cpu").run_device(
            frames, pack_output=True)
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
    agreement = qdq_agreement(got, want, det.config.min_confidence)
    assert agreement["ok"], agreement


@pytest.mark.parametrize("op", ["MatMulInteger", "ConvInteger",
                                "QLinearConv", "QLinearMatMul"])
def test_integer_ops_on_cuda_bit_equal_cpu(cuda, op):
    """The integer matmul and convolution accumulate in float64, exact
    whatever the summation order: the card equals the CPU bit for bit,
    accumulators past 2**24 included."""
    from infercam_onnx_tpu_torch.models import onnx_exec as px
    from infercam_onnx_tpu_torch.models.onnx_reader import OnnxNode

    rng = np.random.default_rng(7)
    u8 = lambda *s: rng.integers(100, 256, size=s).astype(np.uint8)  # noqa
    s8 = lambda *s: rng.integers(-128, 128, size=s).astype(np.int8)  # noqa
    args, attrs = {
        "MatMulInteger": ((u8(64, 4096), s8(4096, 32), np.uint8(3),
                           np.int8(-7)), {}),
        "ConvInteger": ((u8(2, 512, 9, 9), s8(16, 512, 3, 3), np.uint8(0),
                         np.int8(0)), {"pads": [1, 1, 1, 1]}),
        "QLinearConv": ((u8(2, 64, 20, 24), np.float32(0.02),
                         np.uint8(120), s8(32, 32, 3, 3),
                         rng.uniform(1e-3, 1e-2, size=32).astype(np.float32),
                         np.zeros(32, np.int8), np.float32(0.05),
                         np.uint8(20),
                         rng.integers(-2000, 2000, size=32).astype(np.int32)),
                        {"pads": [1, 1, 1, 1], "group": 2}),
        "QLinearMatMul": ((u8(16, 96), np.float32(0.01), np.uint8(130),
                           u8(96, 8), np.float32(0.02), np.uint8(110),
                           np.float32(0.04), np.uint8(16)), {}),
    }[op]
    node = OnnxNode(op, op, [], ["y"], attrs)
    want = px._OPS[op](node, *(torch.from_numpy(np.array(a)) for a in args))
    got = px._OPS[op](node, *(torch.from_numpy(np.array(a)).to(cuda)
                              for a in args))
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


def test_control_flow_under_vmap_on_cuda_matches_cpu(cuda):
    """A data-dependent If and Loop and a Scan under torch.func.vmap on
    the card equal the CPU's (`chip_smoke._control_graphs`), with their
    bodies' constants on the card: no host copy a call."""
    from chip_smoke import _control_graphs
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphExecutor

    rng = np.random.default_rng(3)
    inputs = ((rng.normal(size=(8, 3)).astype(np.float32),),
              (rng.uniform(0.01, 20.0, size=8).astype(np.float32),),
              (np.zeros(8, np.float32),
               rng.normal(size=(8, 5)).astype(np.float32)))
    for graph, args in zip(_control_graphs(), inputs):
        ex = GraphExecutor(graph)
        want = torch.func.vmap(ex)(*(torch.from_numpy(a) for a in args))
        got = torch.func.vmap(ex.to(cuda))(*(torch.from_numpy(a).to(cuda)
                                             for a in args))
        assert ex.host_copies == 0
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)


def test_weights_chain_on_cuda_takes_the_cached_onnx(cuda, tmp_path,
                                                    monkeypatch):
    """With the twin export in the user cache, Detector() on the card runs
    it: bit-identical to the detector given the export's params, and the
    .npz cache it writes gives a bit-identical detector again."""
    import shutil

    from infercam_onnx_tpu_torch.models import convert

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    onnx = REPO / "tests" / "fixtures" / "ultraface_twin_rfb320.onnx"
    shutil.copyfile(onnx, convert.cached_model_path("RFB-320"))
    frames = np.stack(list(load_directory_frames(
        str(REPO / "resources" / "test_pics_synthetic")).values()))
    config = DetectorConfig(compute_dtype="float32")
    got = Detector(config, device=cuda).run_device(frames, pack_output=True)
    npz = tmp_path / "infercam_onnx_tpu" / "weights" / "ultraface-RFB-320.npz"
    assert npz.is_file()
    want = Detector(config, params=convert.params_from_onnx(str(onnx)),
                    device=cuda).run_device(frames, pack_output=True)
    again = Detector(config, device=cuda).run_device(frames,
                                                     pack_output=True)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert int(got[..., 5].sum()) >= 10


def test_goldens_cli_check_on_cuda(cuda, capsys):
    from infercam_onnx_tpu_torch.eval import goldens

    rc = goldens.main([
        "check", "--device", "cuda", "--variant", "RFB-320",
        "--compute-dtype", "float32", "--weights",
        str(REPO / "resources" / "weights" / "ultraface-twin.npz"),
        "--dir", str(REPO / "resources" / "test_pics_synthetic"),
        "--goldens",
        str(REPO / "tests" / "fixtures" / "goldens_twin_rfb320_synthetic.json")])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["passed"], result


@pytest.mark.parametrize("export", ["ultraface_twin_rfb320.onnx",
                                    "crnn_opset13.onnx"])
def test_onnx_run_on_cuda_matches_cpu(cuda, export, tmp_path, capsys):
    """The same seeded inputs through onnx_run on the card and on the CPU:
    every output within 1e-4 (chip_smoke.py graph_ops' tolerance)."""
    from infercam_onnx_tpu_torch import onnx_run

    path = str(REPO / "tests" / "fixtures" / export)
    for device in ("cuda", "cpu"):
        assert onnx_run.main([path, "--device", device, "--runs", "3",
                              "--out", str(tmp_path / f"{device}.npz")]) == 0
    assert "3 runs: " in capsys.readouterr().out
    with np.load(tmp_path / "cuda.npz") as got, \
            np.load(tmp_path / "cpu.npz") as want:
        assert got.files == want.files
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["RFB-320", "RFB-640"])
def test_model_api_slice_on_the_card(cuda, variant):
    """UltraFace.create(...)(x) -> ops.batched_postprocess on the card: one
    NMS launch, the kernel's keep mask on the model's own candidates
    bit-identical to the plain scan's, and so the detections; float32,
    the same packed output as Detector.run_device."""
    from infercam_onnx_tpu_torch import ops
    from infercam_onnx_tpu_torch.detector import pack_detections
    from infercam_onnx_tpu_torch.models import UltraFace

    model = UltraFace.create(variant, rng=0, background_bias=0.75,
                             device=cuda)
    assert model.priors.device == cuda and model.priors.dtype == torch.float32
    frames = np.stack(list(load_directory_frames(
        str(REPO / "resources" / "test_pics_synthetic"),
        resize=(640, 480)).values()))
    config = DetectorConfig(variant=variant, compute_dtype="float32")
    kw = dict(min_confidence=config.min_confidence, max_iou=config.max_iou,
              top_k=config.top_k, max_detections=config.max_detections)
    with torch.inference_mode():
        x = ops.Preprocessor(model.width, model.height, device=cuda)(frames)
        scores, boxes = model(x)
        before = nms.kernel.launches
        got = ops.batched_postprocess(scores, boxes, **kw)
        torch.cuda.synchronize()
        assert nms.kernel.launches == before + 1
        want = ops.batched_postprocess(scores, boxes, impl="scan", **kw)
        cand_boxes, _, cand_valid = pp._select_candidates(
            scores[..., 1], boxes, config.min_confidence, config.top_k)
        args = (cand_boxes.transpose(1, 2).contiguous(),
                cand_valid[:, None, :].float())
        keep = nms.greedy_suppress(*args, max_iou=config.max_iou)
        plain = nms.greedy_suppress_reference(*args, max_iou=config.max_iou)
    assert torch.equal(keep, plain)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2].sum()) > 0
    det = Detector(config, params=model.params, device=cuda)
    assert torch.equal(pack_detections(*got),
                       det.run_device(frames, pack_output=True))
