"""The hand CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernel at
first use); without one each skips with its reason. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

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
