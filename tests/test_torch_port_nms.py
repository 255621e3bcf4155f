"""The port's filter + greedy NMS against the JAX package and the NumPy
oracle.

On the CPU the port's ``impl="kernel"`` runs the kernel wrapper, which
hands CPU tensors to its plain scan version; "xla" and "scan" are the
plain forms. All must give exactly the JAX counts, order and values
(same float formula, same inputs): tolerance 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercam_onnx_tpu.ops import postprocess as jpp
from infercam_onnx_tpu.ops import reference_impl as ref
from infercam_onnx_tpu.ops.pallas.nms import greedy_suppress as jax_suppress
from infercam_onnx_tpu_torch.ops import nms as tnms
from infercam_onnx_tpu_torch.ops import postprocess as tpp

PORT_IMPLS = ("kernel", "xla", "scan")
JAX_IMPLS = ("xla", "pallas_interpret")


def _random_detections(rng, k, n_clusters=12, spread=0.02):
    """Clustered random boxes so NMS actually suppresses things."""
    centers = rng.uniform(0.1, 0.9, size=(n_clusters, 2))
    idx = rng.integers(0, n_clusters, size=k)
    cxy = centers[idx] + rng.normal(0, spread, size=(k, 2))
    wh = rng.uniform(0.05, 0.2, size=(k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)
    conf = rng.uniform(0.0, 1.0, size=k)
    scores = np.stack([1 - conf, conf], axis=1)
    return scores.astype(np.float32), boxes.astype(np.float32)


def _port(conf, boxes, impl, **args):
    b, c, n = tpp.batched_nms(torch.from_numpy(conf),
                              torch.from_numpy(boxes), impl=impl, **args)
    assert n.dtype == torch.int32
    return b.numpy(), c.numpy(), n.numpy()


def _jax(conf, boxes, impl, **args):
    b, c, n = jpp.batched_nms(jnp.asarray(conf), jnp.asarray(boxes),
                              impl=impl, **args)
    return np.asarray(b), np.asarray(c), np.asarray(n)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


ARGS = dict(min_confidence=0.5, max_iou=0.5, top_k=256, max_detections=64)


@functools.lru_cache(maxsize=None)
def _trial(trial):
    rng = np.random.default_rng(100 + trial)
    scores, boxes = _random_detections(rng, k=400)
    conf = scores[:, 1]
    want = {impl: _jax(conf[None], boxes[None], impl, **ARGS)
            for impl in JAX_IMPLS}
    return scores, boxes, want


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("trial", range(4))
def test_matches_jax_and_oracle(trial, impl):
    scores, boxes, want = _trial(trial)
    got = _port(scores[None, :, 1], boxes[None], impl, **ARGS)
    for jimpl in JAX_IMPLS:
        _assert_same(got, want[jimpl])
    oracle = ref.postprocess(scores, boxes, 0.5, 0.5)
    n = int(got[2][0])
    assert n == min(len(oracle), 64)
    for i in range(n):
        np.testing.assert_array_equal(got[0][0, i], oracle[i][0])
        assert got[1][0, i] == np.float32(oracle[i][1])


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_batched_consistency(impl):
    rng = np.random.default_rng(7)
    s1, b1 = _random_detections(rng, k=300)
    s2, b2 = _random_detections(rng, k=300)
    conf = np.stack([s1[:, 1], s2[:, 1]])
    boxes = np.stack([b1, b2])
    both = _port(conf, boxes, impl, top_k=256, max_detections=64)
    one = _port(conf[1:], boxes[1:], impl, top_k=256, max_detections=64)
    assert both[2][1] == one[2][0]
    np.testing.assert_array_equal(both[0][1], one[0][0])
    _assert_same(both, _jax(conf, boxes, "pallas_interpret", top_k=256,
                            max_detections=64))


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_strict_iou_boundary(impl):
    # suppression strictly > max_iou, as in the reference (nn.rs:211)
    boxes = np.array([[0.0, 0.0, 0.2, 0.2], [0.1, 0.0, 0.3, 0.2]],
                     np.float32)
    conf = np.array([0.9, 0.8], np.float32)
    inter = 0.1 * 0.2
    union = 2 * 0.2 * 0.2 - inter
    true_iou = inter / (union + ref.EPS)
    for miou, expect in [(true_iou + 1e-4, 2), (true_iou - 1e-4, 1)]:
        args = dict(max_iou=float(miou), top_k=2, max_detections=2)
        got = _port(conf[None], boxes[None], impl, **args)
        assert int(got[2][0]) == expect
        _assert_same(got, _jax(conf[None], boxes[None], "pallas_interpret",
                               **args))


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_all_ties_go_larger_index_first(impl):
    # equal confidences everywhere: the reference's stable ascending sort
    # popped from the back visits the LARGER prior index first
    k = 40
    x = np.arange(k, dtype=np.float32) * 0.02
    boxes = np.stack([x, x, x + 0.01, x + 0.01], axis=1)  # disjoint
    boxes[[5, 6]] = boxes[4]  # 4, 5, 6 identical: only 6 survives
    conf = np.full((k,), 0.75, np.float32)
    args = dict(top_k=16, max_detections=16)
    got = _port(conf[None], boxes[None], impl, **args)
    want_idx = [39 - i for i in range(16)]
    np.testing.assert_array_equal(got[0][0], boxes[want_idx])
    _assert_same(got, _jax(conf[None], boxes[None], "xla", **args))
    full = _port(conf[None], boxes[None], impl, top_k=k, max_detections=k)
    kept_rows = full[0][0][: int(full[2][0])]
    assert len(kept_rows) == k - 2
    scores = np.stack([1 - conf, conf], axis=1)
    oracle = ref.postprocess(scores, boxes, 0.5, 0.5)
    np.testing.assert_array_equal(kept_rows, np.stack([o[0] for o in oracle]))


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_top_k_and_max_detections_clamp_to_k(impl):
    rng = np.random.default_rng(11)
    scores, boxes = _random_detections(rng, k=50)
    args = dict(top_k=256, max_detections=300)
    got = _port(scores[None, :, 1], boxes[None], impl, **args)
    assert got[0].shape == (1, 50, 4) and got[1].shape == (1, 50)
    _assert_same(got, _jax(scores[None, :, 1], boxes[None], "xla", **args))


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("top_k", [2, 300])
def test_k_not_a_multiple_of_64(impl, top_k):
    rng = np.random.default_rng(top_k)
    s, b = _random_detections(rng, k=700)
    conf = np.stack([s[:, 1], s[::-1, 1]])
    boxes = np.stack([b, b[::-1]])
    args = dict(top_k=top_k, max_detections=128)
    got = _port(conf, boxes, impl, **args)
    _assert_same(got, _jax(conf, boxes, "pallas_interpret", **args))


@pytest.mark.parametrize("k", [2, 64, 256, 300])
def test_suppress_matches_pallas_kernel(k):
    """The kernel wrapper's keep mask (plain version on CPU) equals the
    Pallas kernel's, run in interpret mode, on the same candidates."""
    rng = np.random.default_rng(k)
    _, boxes = _random_detections(rng, k=3 * k)
    boxes_t = np.ascontiguousarray(boxes.reshape(3, k, 4).transpose(0, 2, 1))
    valid = (rng.uniform(size=(3, 1, k)) < 0.8).astype(np.float32)
    want = np.asarray(jax_suppress(jnp.asarray(boxes_t), jnp.asarray(valid),
                                   max_iou=0.5, interpret=True))
    got = tnms.greedy_suppress(torch.from_numpy(boxes_t),
                               torch.from_numpy(valid), max_iou=0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    ref_keep = tnms.greedy_suppress_reference(
        torch.from_numpy(boxes_t), torch.from_numpy(valid), max_iou=0.5)
    np.testing.assert_array_equal(ref_keep.numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """Only greedy_suppress routes CPU tensors to the plain version; the
    kernel object itself takes CUDA tensors or raises, before any build
    or launch."""
    kernel = tnms.NmsKernel()
    boxes_t = torch.zeros((1, 4, 8))
    valid = torch.ones((1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernel(boxes_t, valid, 0.5)
    with pytest.raises(ValueError, match=r"\[B, 4, K\]"):
        kernel(torch.zeros((1, 3, 8)), valid, 0.5)
    assert kernel.launches == 0 and kernel._lib is None


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        tpp.batched_nms(torch.zeros((1, 4)), torch.zeros((1, 4, 4)),
                        impl="pallas")
