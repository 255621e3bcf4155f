"""The port's filter + greedy NMS against the JAX package and the NumPy
oracle.

On the CPU the port's ``impl="kernel"`` runs the kernel wrapper, which
hands CPU tensors to its plain scan version; "xla" and "scan" are the
plain forms. All must give exactly the JAX counts, order and values
(same float formula, same inputs): tolerance 0.
"""

import functools

import hypothesis
import hypothesis.strategies as st
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


# -- a NumPy model of csrc/nms.cu --------------------------------------------
#
# The kernel's bit logic, step for step, so that it can be rehearsed
# without a card: the valid-pairs-only bitmask, built by the CTAs of a
# cluster in units of one 8-row group against one 64-column word (row
# group g of each 64-row band belongs to CTA g % cluster), each unit
# written once into the first CTA's bitmask (band by band from the
# diagonal word on, word-major), and the scan that resolves one
# 64-candidate word at a time (the ctz walk over the diagonal block, a
# 32-candidate half at a time, then the OR propagation into later words).
# Words are Python ints; a word the scan reads must have been written.

ROWS = 8
GROUPS = 64 // ROWS
WARPS = 16
MASK32 = (1 << 32) - 1


def _pow2_floor(x):
    p = 1
    while 2 * p <= x:
        p *= 2
    return p


def _cluster_size(batch, k, sms=132):
    """csrc/nms.cu:cluster_size."""
    by_work = -(-_tiles((k + 63) // 64) * GROUPS // WARPS)
    need = 1
    while need < by_work and need < 8:
        need *= 2
    return min(need, _pow2_floor(max(sms // batch, 1)))


def _tiles(words):
    return words * (words + 1) // 2


def _band_base(jw, kw):
    return 64 * (jw * kw - jw * (jw - 1) // 2)


def _suppresses(j, cols, x0, y0, x1, y1, ar, max_iou):
    """iou(j, i) > max_iou for each i in ``cols``, float32 as the kernel,
    which skips the divide where the intersection is +-0."""
    tlx = np.maximum(x0[j], x0[cols])
    tly = np.maximum(y0[j], y0[cols])
    brx = np.minimum(x1[j], x1[cols])
    bry = np.minimum(y1[j], y1[cols])
    w, h = brx - tlx, bry - tly
    inter = np.where((w < 0) | (h < 0), np.float32(0), w * h)
    den = ((ar[j] + ar[cols]) - inter) + np.float32(1e-7)
    miou = np.float32(max_iou)
    zero = (den == den) & (den != 0) & (np.float32(0) > miou)
    nonzero = inter[inter != 0] / den[inter != 0] > miou
    out = zero.copy()
    out[inter != 0] = nonzero
    return out


def model_suppress(boxes_t, valid, max_iou, cluster):
    """Keep mask [B, 1, K] and the number of IoUs computed per image."""
    bsz, _, k = boxes_t.shape
    kw = (k + 63) // 64
    lg = cluster.bit_length() - 1
    glg = 3 - lg  # row groups per band in each CTA: 1 << glg
    keep = np.zeros((bsz, 1, k), np.float32)
    pairs = []
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for b in range(bsz):
            ok = valid[b, 0] > 0.5
            vbits = [sum(1 << t for t in range(64) if 64 * w + t < k
                         and ok[64 * w + t]) for w in range(kw)]
            wn = max((w + 1 for w in range(kw) if vbits[w]), default=0)
            n = 64 * wn - (64 - vbits[wn - 1].bit_length()) if wn else 0
            x0, y0, x1, y1 = (boxes_t[b, c, :n] for c in range(4))
            w_, h_ = x1 - x0, y1 - y0
            ar = np.where((w_ < 0) | (h_ < 0), np.float32(0), w_ * h_)
            # phase 1: each CTA's units, into the first CTA's bitmask
            bits = {}
            computed = 0
            for rank in range(cluster):
                for v in range(_tiles(wn) << glg):
                    t, jw = v >> glg, 0
                    while t >= wn - jw:
                        t -= wn - jw
                        jw += 1
                    iw = jw + t
                    local = v & ((1 << glg) - 1)
                    j0 = 64 * jw + ((local << lg) + rank) * ROWS
                    for r in range(ROWS):
                        j = j0 + r
                        word = 0
                        if (vbits[jw] >> (j & 63)) & 1:
                            cols = np.array(
                                [i for i in range(64 * iw, 64 * iw + 64)
                                 if (vbits[iw] >> (i & 63)) & 1 and i > j],
                                np.int64)
                            computed += cols.size
                            if cols.size:
                                hit = _suppresses(j, cols, x0, y0, x1, y1,
                                                  ar, max_iou)
                                for i in cols[hit]:
                                    word |= 1 << (int(i) & 63)
                        at = _band_base(jw, kw) + (iw - jw) * 64 + (j & 63)
                        assert at not in bits and at < 64 * _tiles(kw)
                        bits[at] = word
            pairs.append(computed)

            def row(j, jw):
                """Row j, indexed by word."""
                return {iw: bits[_band_base(jw, kw) + (iw - jw) * 64 + (j & 63)]
                        for iw in range(jw, wn)}

            # phase 2, a word at a time; removed[w] is lane w's word
            removed = [0] * kw
            for jw in range(wn):
                cand = vbits[jw] & ~removed[jw]
                rows = {t: row(64 * jw + t, jw) for t in range(64)
                        if (cand >> t) & 1}
                clo, chi, klo, khi = cand & MASK32, cand >> 32, 0, 0
                while clo:
                    t = (clo & -clo).bit_length() - 1  # ctz
                    klo |= 1 << t
                    diag = rows[t][jw]
                    clo &= ~diag & (MASK32 << (t + 1)) & MASK32
                    chi &= ~(diag >> 32) & MASK32
                while chi:
                    t = (chi & -chi).bit_length() - 1
                    khi |= 1 << t
                    chi &= ~(rows[32 + t][jw] >> 32) & (MASK32 << (t + 1))
                    chi &= MASK32
                kept = klo | khi << 32
                for t in range(64):
                    if (kept >> t) & 1:
                        keep[b, 0, 64 * jw + t] = 1.0
                for iw in range(jw + 1, wn):
                    for t in range(64):
                        if (kept >> t) & 1:
                            removed[iw] |= rows[t][iw]
    return keep, pairs


def _valid_mask(kind, rng, b, k):
    if kind == "dense":
        return rng.uniform(size=(b, k)) < 0.8
    if kind == "sparse":
        return rng.uniform(size=(b, k)) < 0.05
    if kind == "prefix":  # the main path's shape: valid is a prefix
        return np.arange(k)[None, :] < rng.integers(0, k + 1, size=(b, 1))
    if kind == "empty":
        return np.zeros((b, k), bool)
    if kind == "single":
        v = np.zeros((b, k), bool)
        v[np.arange(b), rng.integers(0, k, size=b)] = True
        return v
    if kind == "nan_first":  # a NaN confidence sorts first and is invalid
        v = np.arange(k)[None, :] < rng.integers(1, k + 1, size=(b, 1))
        v[:, 0] = False
        return v
    raise ValueError(kind)


MASKS = ("dense", "sparse", "prefix", "empty", "single", "nan_first")
MODEL_KS = (2, 63, 64, 65, 256, 300, 1024)


@functools.lru_cache(maxsize=None)
def _model_inputs(k):
    """Per K, one batch with a row per mask kind (3 images each), the JAX
    Pallas kernel's keep mask (interpret mode) and the plain version's."""
    rng = np.random.default_rng(1000 + k)
    per = 3
    _, boxes = _random_detections(rng, k=per * len(MASKS) * k)
    boxes_t = np.ascontiguousarray(
        boxes.reshape(per * len(MASKS), k, 4).transpose(0, 2, 1))
    valid = np.concatenate([_valid_mask(m, rng, per, k) for m in MASKS])
    valid = valid[:, None, :].astype(np.float32)
    want = np.asarray(jax_suppress(jnp.asarray(boxes_t), jnp.asarray(valid),
                                   max_iou=0.5, interpret=True))
    ref_keep = tnms.greedy_suppress_reference(
        torch.from_numpy(boxes_t), torch.from_numpy(valid), max_iou=0.5)
    np.testing.assert_array_equal(ref_keep.numpy(), want)
    return boxes_t, valid, want, per


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("k", MODEL_KS)
def test_kernel_model_matches_reference_and_pallas(k, mask):
    """The kernel's algorithm, at the cluster sizes its launch picks for
    B = 1, 16 and 64, gives exactly the greedy keep mask, and computes an
    IoU only for pairs j < i < n with both candidates valid."""
    boxes_t, valid, want, per = _model_inputs(k)
    s = slice(MASKS.index(mask) * per, (MASKS.index(mask) + 1) * per)
    for cluster in sorted({_cluster_size(b, k) for b in (1, 16, 64)}):
        got, pairs = model_suppress(boxes_t[s], valid[s], 0.5, cluster)
        np.testing.assert_array_equal(got, want[s])
        nvalid = (valid[s, 0] > 0.5).sum(-1)
        assert pairs == [int(v * (v - 1) // 2) for v in nvalid]


def test_kernel_model_cluster_sizes():
    """B * cluster fills 132 SMs, at most 8; small K takes fewer CTAs."""
    assert [_cluster_size(b, 256) for b in (1, 16, 17, 33, 64, 132, 500)] == [
        8, 8, 4, 4, 2, 1, 1]
    assert [_cluster_size(16, k) for k in (2, 64, 65, 128, 256, 1024)] == [
        1, 1, 2, 2, 8, 8]


def test_kernel_model_duplicates_and_nan_boxes():
    """Exact duplicates (IoU 1 with a later copy), NaN coordinates (IoU
    NaN: never suppresses) and ill-formed boxes (zero area)."""
    rng = np.random.default_rng(3)
    _, boxes = _random_detections(rng, k=2 * 200)
    boxes = boxes.reshape(2, 200, 4)
    boxes[:, 50:60] = boxes[:, 40:50]
    boxes[:, 100:110] = boxes[:, 0:1]
    boxes[0, 120:125, 1] = np.nan
    boxes[1, 130:140] = boxes[1, 130:140][:, [2, 3, 0, 1]]  # x1 < x0
    boxes_t = np.ascontiguousarray(boxes.transpose(0, 2, 1))
    valid = np.ones((2, 1, 200), np.float32)
    want = tnms.greedy_suppress_reference(
        torch.from_numpy(boxes_t), torch.from_numpy(valid)).numpy()
    for cluster in (1, 2, 8):
        np.testing.assert_array_equal(
            model_suppress(boxes_t, valid, 0.5, cluster)[0], want)
    pallas = np.asarray(jax_suppress(jnp.asarray(boxes_t), jnp.asarray(valid),
                                     max_iou=0.5, interpret=True))
    np.testing.assert_array_equal(want, pallas)
    assert want[:, 0, 50:60].sum() == 0  # each a copy of a kept or removed one


@pytest.mark.parametrize("max_iou", [0.0, -0.5])
def test_kernel_model_skips_the_divide_exactly(max_iou):
    """Where the intersection is +-0 the kernel decides without dividing:
    +-0 / den is +-0 (> max_iou iff max_iou < 0) unless den is 0 or NaN.
    Zero-area and NaN boxes reach each branch."""
    rng = np.random.default_rng(5)
    _, boxes = _random_detections(rng, k=130)
    boxes[10:20, 2:] = boxes[10:20, :2]  # zero area: den = 1e-7 or 0
    boxes[20:30] = 0.0  # zero boxes: den = 1e-7
    boxes[30:35, 0] = np.nan
    boxes_t = np.ascontiguousarray(boxes.T[None])
    valid = np.ones((1, 1, 130), np.float32)
    want = tnms.greedy_suppress_reference(
        torch.from_numpy(boxes_t), torch.from_numpy(valid),
        max_iou=max_iou).numpy()
    for cluster in (1, 8):
        np.testing.assert_array_equal(
            model_suppress(boxes_t, valid, max_iou, cluster)[0], want)


@pytest.mark.parametrize("sign", [1, -1])
def test_kernel_model_strict_iou_boundary(sign):
    boxes_t = np.array([[[0.0, 0.1], [0.0, 0.0], [0.2, 0.3], [0.2, 0.2]]],
                       np.float32)
    true_iou = (0.1 * 0.2) / (2 * 0.2 * 0.2 - 0.1 * 0.2 + 1e-7)
    valid = np.ones((1, 1, 2), np.float32)
    got, _ = model_suppress(boxes_t, valid, true_iou + sign * 1e-4, 1)
    assert got[0, 0].tolist() == ([1, 1] if sign > 0 else [1, 0])


@hypothesis.settings(max_examples=25, deadline=None, derandomize=True,
                     database=None)
@hypothesis.given(k=st.integers(1, 200), cluster=st.sampled_from([1, 2, 4, 8]),
                  seed=st.integers(0, 2**32 - 1), density=st.floats(0, 1))
def test_kernel_model_random_masks(k, cluster, seed, density):
    rng = np.random.default_rng(seed)
    _, boxes = _random_detections(rng, k=k)
    boxes_t = np.ascontiguousarray(boxes.T[None])
    valid = (rng.uniform(size=(1, 1, k)) < density).astype(np.float32)
    want = tnms.greedy_suppress_reference(
        torch.from_numpy(boxes_t), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(
        model_suppress(boxes_t, valid, 0.5, cluster)[0], want)
