"""The port's preprocess against the JAX package's ``preprocess_images``.

Both resize with the same float32 matrices but take the float32 sums in
another order (oneDNN vs Eigen blocking), and XLA rewrites ``/ 255`` and
``/ STD`` into reciprocal multiplies fused with the mean. So the test
maps both outputs back to the u8 grid and requires equal levels except
where the exact (float64) resample sum lies within 1e-3 of a rounding
boundary ``n + 0.5``: there either rounding is a correct float32 result,
and the two may differ by one level. Normalized values of equal levels
agree within 1e-6 (two float32 ulps at the largest magnitude, ~2.6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercam_onnx_tpu.ops import preprocess as jpp
from infercam_onnx_tpu_torch.ops import preprocess as tpp


def _levels(x):
    """Normalized output -> u8 levels (exact up to float32 rounding)."""
    return np.round((x * tpp.STD + tpp.MEAN) * 255.0).astype(np.int64)


@pytest.mark.parametrize("in_w,in_h,max_share", [
    (640, 480, 1e-4),  # ratio 2: only the edge rows' sums are inexact
    (1280, 720, 1e-3),
    (333, 251, 1e-3),  # odd size, upscaling
])
def test_matches_jax(in_w, in_h, max_share):
    rng = np.random.default_rng(in_w)
    img = rng.integers(0, 256, (2, in_h, in_w, 3), dtype=np.uint8)
    r_h = tpp.triangle_resize_matrix(in_h, 240)
    r_w = tpp.triangle_resize_matrix(in_w, 320)
    np.testing.assert_array_equal(r_h, jpp.triangle_resize_matrix(in_h, 240))
    np.testing.assert_array_equal(r_w, jpp.triangle_resize_matrix(in_w, 320))

    want = np.asarray(jpp.preprocess_images(
        jnp.asarray(img), jnp.asarray(r_h), jnp.asarray(r_w)))
    got = tpp.preprocess_images(torch.from_numpy(img), torch.from_numpy(r_h),
                                torch.from_numpy(r_w))
    assert got.dtype == torch.float32 and got.shape == (2, 240, 320, 3)
    got = got.numpy()

    exact = np.einsum("oH,bHWc->boWc", r_h.astype(np.float64),
                      img.astype(np.float64))
    exact = np.einsum("oW,bhWc->bhoc", r_w.astype(np.float64), exact)
    ambiguous = np.abs(exact - np.floor(exact) - 0.5) < 1e-3
    lg, lw = _levels(got), _levels(want)
    np.testing.assert_array_equal(lg[~ambiguous], lw[~ambiguous])
    assert np.abs(lg - lw).max() <= 1
    assert np.mean(lg != lw) <= max_share
    same = lg == lw
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-6)


def test_rounds_half_away_from_zero():
    """An exact .5 resample sum rounds up (floor(x + 0.5)), where
    torch.round would round half to even."""
    img = np.zeros((1, 2, 2, 3), np.uint8)
    img[0, :, 0] = 0
    img[0, :, 1] = 5  # 2 -> 1 horizontal average: 2.5
    r_h = np.eye(2, dtype=np.float32)
    r_w = np.array([[0.5, 0.5]], np.float32)
    out = tpp.preprocess_images(torch.from_numpy(img), torch.from_numpy(r_h),
                                torch.from_numpy(r_w)).numpy()
    np.testing.assert_array_equal(_levels(out), 3)
    want = np.asarray(jpp.preprocess_images(
        jnp.asarray(img), jnp.asarray(r_h), jnp.asarray(r_w)))
    np.testing.assert_array_equal(_levels(want), 3)


def test_preprocessor_caches_matrices_on_device():
    pre = tpp.Preprocessor(320, 240, torch.device("cpu"))
    r_h, r_w = pre.matrices(640, 480)
    assert pre.matrices(640, 480)[0] is r_h
    assert r_h.shape == (240, 480) and r_w.shape == (320, 640)
    assert r_h.device.type == "cpu" and r_h.dtype == torch.float32
    frames = torch.zeros((1, 480, 640, 3), dtype=torch.uint8)
    out = tpp.preprocess_images(frames, *pre.matrices(640, 480))
    assert out.shape == (1, 240, 320, 3)


def test_resize_matmuls_run_in_ieee_float32_whatever_the_caller_set(
        monkeypatch):
    """A caller's TF32 setting is overridden inside preprocess_images and
    restored after it, also when the call raises."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    seen = []
    real_matmul = torch.matmul

    def recording_matmul(a, b):
        seen.append((matmul.fp32_precision, conv.fp32_precision))
        return real_matmul(a, b)

    monkeypatch.setattr(torch, "matmul", recording_matmul)
    try:
        matmul.fp32_precision = conv.fp32_precision = "tf32"
        img = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
        r = torch.full((2, 4), 0.25)
        tpp.preprocess_images(img, r, r)
        assert seen == [("ieee", "ieee")] * 2
        assert (matmul.fp32_precision, conv.fp32_precision) == ("tf32",
                                                                "tf32")
        with pytest.raises(RuntimeError):
            tpp.preprocess_images(img, torch.zeros((2, 5)), r)
        assert (matmul.fp32_precision, conv.fp32_precision) == ("tf32",
                                                                "tf32")
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
