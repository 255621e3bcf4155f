"""The port's int8 quantized op family against the JAX package's
(``models/onnx_exec.py:1866-2044`` there): QuantizeLinear,
DequantizeLinear, QLinearConv, QLinearMatMul, MatMulInteger, ConvInteger
and DynamicQuantizeLinear, on NumPy (where the port, as JAX, keeps NumPy)
and on tensors, bit for bit; the pins of ``tests/test_onnx_exec_ops.py``
(banker's rounding, per-axis parameters, widening before the zero point,
exact integer accumulation, the requant envelope against a float64
oracle, the QDQ export of a static-quantized torch net).
"""

import copy
import warnings

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from infercam_onnx_tpu.models import onnx_exec as jx  # noqa: E402
from infercam_onnx_tpu.models import onnx_reader as jr  # noqa: E402
from infercam_onnx_tpu_torch.models import onnx_exec as px  # noqa: E402
from infercam_onnx_tpu_torch.models import onnx_reader as pr  # noqa: E402

import test_onnx_exec_ops as jtests  # noqa: E402  (oracles, _QuantizedNet)
from onnx_export_util import export_onnx  # noqa: E402
from test_torch_port_onnx import _as_list, _both_ops, _nodes  # noqa: E402

_R = np.random.default_rng(300)


def _u8(*shape):
    return _R.integers(0, 256, size=shape).astype(np.uint8)


def _s8(*shape):
    return _R.integers(-128, 128, size=shape).astype(np.int8)


X = _R.normal(scale=3.0, size=(2, 4, 5, 5)).astype(np.float32)
X[0, 0, 0, :4] = [0.05, 0.15, -0.05, -0.15]  # exact .5 ties at scale 0.1
SCALE4 = np.array([0.05, 0.1, 0.2, 0.4], np.float32)
ZP4 = np.array([0, 10, -10, 3], np.int8)

# (op, attrs, args, n_out): every quantized op, results compared exactly
QUANT_CASES = {
    "QuantizeLinear": ("QuantizeLinear", {}, (X, np.float32(0.1),
                                              np.uint8(128)), 1),
    "QuantizeLinear_per_axis": ("QuantizeLinear", dict(axis=1),
                                (X, SCALE4, ZP4), 1),
    "QuantizeLinear_no_zp": ("QuantizeLinear", {}, (X, np.float32(0.07)),
                             1),
    "DequantizeLinear": ("DequantizeLinear", {}, (_u8(3, 7), np.float32(0.1),
                                                  np.uint8(120)), 1),
    "DequantizeLinear_per_axis": ("DequantizeLinear", dict(axis=1),
                                  (_s8(2, 4, 3), SCALE4, ZP4), 1),
    "DequantizeLinear_extremes": ("DequantizeLinear", {},
                                  (np.array([-128, 127], np.int8),
                                   np.float32(1.0), np.int8(127)), 1),
    "DequantizeLinear_int32_bias": ("DequantizeLinear", {},
                                    (_R.integers(-5000, 5000, size=(6,))
                                     .astype(np.int32), np.float32(1e-4)),
                                    1),
    "QLinearConv": ("QLinearConv", dict(pads=[1, 1, 1, 1], group=2),
                    (_u8(2, 4, 7, 7), np.float32(0.02), np.uint8(120),
                     _s8(6, 2, 3, 3), _R.uniform(0.001, 0.01, size=(6,))
                     .astype(np.float32), np.zeros((6,), np.int8),
                     np.float32(0.05), np.uint8(20),
                     _R.integers(-2000, 2000, size=(6,)).astype(np.int32)),
                    1),
    "QLinearConv_strided_int8": ("QLinearConv", dict(strides=[2, 2],
                                                     auto_pad=b"SAME_UPPER"),
                                 (_s8(1, 3, 8, 8), np.float32(0.03),
                                  np.int8(-3), _s8(4, 3, 3, 3),
                                  np.float32(0.004), np.int8(0),
                                  np.float32(0.2), np.int8(5)), 1),
    "QLinearMatMul": ("QLinearMatMul", {}, (_u8(4, 8), np.float32(0.01),
                                            np.uint8(130), _u8(8, 3),
                                            np.float32(0.02), np.uint8(110),
                                            np.float32(0.04), np.uint8(16)),
                      1),
    "MatMulInteger": ("MatMulInteger", {}, (_u8(6, 9), _s8(9, 5),
                                            np.uint8(113), np.int8(-7)), 1),
    "MatMulInteger_no_zp": ("MatMulInteger", {}, (_u8(2, 6, 9), _s8(9, 5)),
                            1),
    "MatMulInteger_per_column_zp": ("MatMulInteger", {},
                                    (_u8(6, 9), _s8(9, 5), np.uint8(3),
                                     _s8(5)), 1),
    "ConvInteger": ("ConvInteger", dict(pads=[1, 1, 1, 1]),
                    (_u8(1, 3, 8, 8), _s8(4, 3, 3, 3), np.uint8(100),
                     np.int8(5)), 1),
    "ConvInteger_per_channel_zp": ("ConvInteger", dict(dilations=[2, 2]),
                                   (_u8(2, 3, 9, 9), _s8(4, 3, 3, 3), None,
                                    _s8(4)), 1),
    "DynamicQuantizeLinear": ("DynamicQuantizeLinear", {},
                              (_R.normal(size=(3, 7)).astype(np.float32),),
                              3),
    "DynamicQuantizeLinear_zeros": ("DynamicQuantizeLinear", {},
                                    (np.zeros((4,), np.float32),), 3),
}


def _exact(got, want):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(QUANT_CASES))
def test_quant_op_matches_jax_on_numpy(name):
    """Concrete inputs: the port's result is NumPy (so the build folds a
    constant weight's dequantization), bit-equal to the JAX op's."""
    op, attrs, args, n_out = QUANT_CASES[name]
    got, want = _both_ops(op, attrs, args, n_out)
    assert all(isinstance(g, (np.ndarray, np.generic))
               for g in _as_list(got))
    _exact(got, want)


@pytest.mark.parametrize("name", sorted(QUANT_CASES))
def test_quant_op_matches_jax_on_tensors(name):
    """Every input a tensor (zero points and scales as a graph's buffers
    are): bit-equal to the JAX op on the same values."""
    op, attrs, args, n_out = QUANT_CASES[name]
    targs = [None if a is None else torch.from_numpy(np.array(a))
             for a in args]
    jn, pn = _nodes(op, attrs, n_out)
    got = px._OPS[op](pn, *targs)
    assert all(isinstance(g, torch.Tensor) for g in _as_list(got))
    _exact([g.numpy() for g in _as_list(got)], jx._OPS[op](jn, *args))


def test_quantize_dequantize_linear_pins():
    """Banker's rounding on exact .5 ties, per-axis int8, the round trip
    through Dequantize, and int8 extremes widened before the zero point
    (-128 - 127 = -255, not a wrapped int8), against the JAX test's NumPy
    oracles."""
    got = px._OPS["QuantizeLinear"](_nodes("QuantizeLinear")[1],
                                    torch.from_numpy(X), np.float32(0.1),
                                    np.uint8(128))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), jtests._np_quantize(X, 0.1, 128, np.uint8))
    assert got.numpy()[0, 0, 0, :4].tolist() == [128, 130, 128, 126]
    q = px._OPS["QuantizeLinear"](_nodes("QuantizeLinear", dict(axis=1))[1],
                                  torch.from_numpy(X), SCALE4, ZP4)
    np.testing.assert_array_equal(
        q.numpy(), jtests._np_quantize(X, SCALE4, ZP4, np.int8))
    dq = px._OPS["DequantizeLinear"](
        _nodes("DequantizeLinear", dict(axis=1))[1], q, SCALE4, ZP4)
    np.testing.assert_array_equal(
        dq.numpy(), jtests._np_dequantize(q.numpy(), SCALE4, ZP4))
    dq = px._OPS["DequantizeLinear"](
        _nodes("DequantizeLinear")[1], torch.tensor([-128, 127],
                                                    dtype=torch.int8),
        np.float32(1.0), torch.tensor(127, dtype=torch.int8))
    assert dq.tolist() == [-255.0, 0.0]


def test_quantize_divides_by_the_scale():
    """y = round(x / s): a value whose quotient is an exact tie under the
    division but not under the reciprocal's product rounds half to even
    through the division, as the spec and the JAX op do."""
    s = np.float32(0.011)
    x = np.float32(0.0385)  # x / s = 3.5 exactly; x * (1 / s) = 3.4999998
    assert np.float32(x / s) == 3.5 and np.float32(x * (1 / s)) < 3.5
    got = px._OPS["QuantizeLinear"](_nodes("QuantizeLinear")[1],
                                    torch.tensor([x]), torch.tensor(s),
                                    torch.tensor(0, dtype=torch.uint8))
    assert got.tolist() == [4]
    _exact(got.numpy(), jx._OPS["QuantizeLinear"](
        _nodes("QuantizeLinear")[0], np.array([x]), s, np.uint8(0)))


def test_matmul_integer_and_conv_integer_pins():
    """Exact integer results (int32) against int64 oracles, zero points
    given and omitted."""
    rng = np.random.default_rng(32)
    a = rng.integers(0, 256, size=(6, 9)).astype(np.uint8)
    b = rng.integers(-128, 128, size=(9, 5)).astype(np.int8)
    for args, want in (
            ((a, b, np.uint8(113), np.int8(-7)),
             (a.astype(np.int64) - 113) @ (b.astype(np.int64) + 7)),
            ((a, b), a.astype(np.int64) @ b.astype(np.int64))):
        got = px._OPS["MatMulInteger"](
            _nodes("MatMulInteger")[1],
            *(torch.from_numpy(np.array(v)) for v in args))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    x = rng.integers(0, 256, size=(1, 3, 8, 8)).astype(np.uint8)
    w = rng.integers(-128, 128, size=(4, 3, 3, 3)).astype(np.int8)
    got = px._OPS["ConvInteger"](_nodes("ConvInteger",
                                        dict(pads=[1, 1, 1, 1]))[1],
                                 torch.from_numpy(x), torch.from_numpy(w),
                                 np.uint8(100), np.int8(5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jtests._exact_int_conv(
        x.astype(np.int64) - 100, w.astype(np.int64) - 5))


def test_integer_accumulation_exact_past_float32():
    """Accumulators far past 2**24 stay exact: the float64 accumulation
    equals the int64 oracle where a float32 one loses low bits (the
    reason the port accumulates in float64, not float32)."""
    rng = np.random.default_rng(36)
    x = rng.integers(100, 256, size=(1, 512, 3, 3)).astype(np.uint8)
    w = rng.integers(100, 128, size=(8, 512, 3, 3)).astype(np.int8)
    want = jtests._exact_int_conv(x.astype(np.int64), w.astype(np.int64),
                                  pads=(0, 0))
    assert int(np.abs(want).min()) > 2 ** 24
    got = px._OPS["ConvInteger"](_nodes("ConvInteger")[1],
                                 torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    lossy = torch.nn.functional.conv2d(torch.from_numpy(x).float(),
                                       torch.from_numpy(w).float())
    assert not np.array_equal(lossy.numpy().astype(np.int64), want)


def test_qlinear_conv_per_channel_groups_bias_pin():
    rng = np.random.default_rng(33)
    x = rng.integers(0, 256, size=(2, 4, 7, 7)).astype(np.uint8)
    w = rng.integers(-128, 128, size=(6, 2, 3, 3)).astype(np.int8)
    bias = rng.integers(-2000, 2000, size=(6,)).astype(np.int32)
    w_s = rng.uniform(0.001, 0.01, size=(6,)).astype(np.float32)
    args = (x, np.float32(0.02), np.uint8(120), w, w_s,
            np.zeros((6,), np.int8), np.float32(0.05), np.uint8(20), bias)
    got = px._OPS["QLinearConv"](
        _nodes("QLinearConv", dict(pads=[1, 1, 1, 1], group=2))[1],
        *(torch.from_numpy(np.array(v)) for v in args))
    acc = jtests._exact_int_conv(x.astype(np.int64) - 120,
                                 w.astype(np.int64), groups=2)
    acc = acc + bias.reshape(1, -1, 1, 1)
    m = (np.float32(0.02) * w_s / np.float32(0.05)).astype(np.float32)
    want = np.clip(np.round(acc.astype(np.float32) * m.reshape(1, -1, 1, 1))
                   + np.float32(20), 0, 255).astype(np.uint8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_q_requant_large_accumulator_envelope():
    """The float32 requant envelope of JAX's `_q_requant` docstring:
    accumulators beyond 2**24 requantize at most one output quantum from a
    float64 oracle, and over 99% exactly; the port's output equals JAX's
    bit for bit (the same float32 requant)."""
    rng = np.random.default_rng(36)
    x = rng.integers(100, 256, size=(1, 512, 3, 3)).astype(np.uint8)
    w = rng.integers(100, 128, size=(8, 512, 3, 3)).astype(np.int8)
    args = (x, np.float32(0.02), np.uint8(0), w, np.float32(0.002),
            np.int8(0), np.float32(25.0), np.uint8(0))
    jn, pn = _nodes("QLinearConv", dict(pads=[0, 0, 0, 0]))
    got = px._OPS["QLinearConv"](
        pn, *(torch.from_numpy(np.array(v)) for v in args)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jx._OPS["QLinearConv"](
        jn, *args)))
    acc = jtests._exact_int_conv(x.astype(np.int64), w.astype(np.int64),
                                 pads=(0, 0))
    assert int(np.abs(acc).min()) > 2 ** 24
    y64 = acc.astype(np.float64) * (np.float64(0.02) * np.float64(0.002)
                                    / np.float64(25.0))
    assert 0.0 < y64.min() and y64.max() < 255.0  # clip inactive
    dev = got.astype(np.int32) - np.clip(np.rint(y64), 0, 255).astype(
        np.int32)
    assert int(np.abs(dev).max()) <= 1
    assert (dev == 0).mean() > 0.99


def test_qlinear_matmul_pin_and_per_axis_refusal():
    rng = np.random.default_rng(34)
    a = rng.integers(0, 256, size=(4, 8)).astype(np.uint8)
    b = rng.integers(0, 256, size=(8, 3)).astype(np.uint8)
    args = (a, np.float32(0.01), np.uint8(130), b, np.float32(0.02),
            np.uint8(110), np.float32(0.04), np.uint8(16))
    got = px._OPS["QLinearMatMul"](
        _nodes("QLinearMatMul")[1],
        *(torch.from_numpy(np.array(v)) for v in args))
    acc = (a.astype(np.int64) - 130) @ (b.astype(np.int64) - 110)
    want = np.clip(np.round(acc.astype(np.float32)
                            * np.float32(0.01 * 0.02 / 0.04))
                   + np.float32(16), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)
    bad = list(args)
    bad[1] = np.array([0.01, 0.02], np.float32)
    jn, pn = _nodes("QLinearMatMul")
    with pytest.raises(ValueError) as perr:
        px._OPS["QLinearMatMul"](pn, *bad)
    with pytest.raises(ValueError) as jerr:
        jx._OPS["QLinearMatMul"](jn, *bad)
    assert str(perr.value) == str(jerr.value)


def test_dynamic_quantize_linear_pin():
    """Scale from the zero-including range, zero point round(-min/scale),
    the all-zero input's safe scale; half a quantum of error at most."""
    rng = np.random.default_rng(35)
    for x in (rng.normal(size=(3, 7)).astype(np.float32),
              rng.uniform(0.5, 4.0, size=(5,)).astype(np.float32),
              rng.uniform(-4.0, -0.5, size=(5,)).astype(np.float32),
              np.zeros((4,), np.float32)):
        y, s, zp = px._OPS["DynamicQuantizeLinear"](
            _nodes("DynamicQuantizeLinear", n_out=3)[1], torch.from_numpy(x))
        xmin, xmax = min(x.min(), 0.0), max(x.max(), 0.0)
        scale = np.float32((xmax - xmin) / 255.0)
        safe = scale if scale > 0 else np.float32(1.0)
        wzp = np.uint8(np.clip(np.round(-xmin / safe), 0, 255))
        np.testing.assert_allclose(float(s), scale, rtol=1e-6)
        assert int(zp) == int(wzp)
        np.testing.assert_array_equal(y.numpy(), np.clip(
            np.round(x / safe) + np.float32(wzp), 0, 255).astype(np.uint8))
        np.testing.assert_allclose(
            (y.numpy().astype(np.float32) - np.float32(wzp)) * scale, x,
            atol=float(safe) / 2 + 1e-7)


def test_blocked_quantization_raises_like_jax():
    for op in ("QuantizeLinear", "DequantizeLinear"):
        jn, pn = _nodes(op, dict(block_size=4))
        args = (np.zeros((4, 4), np.float32 if op[0] == "Q" else np.int8),
                np.ones((4, 1), np.float32))
        with pytest.raises(ValueError) as perr:
            px._OPS[op](pn, *args)
        with pytest.raises(ValueError) as jerr:
            jx._OPS[op](jn, *args)
        assert str(perr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def quantized_export(tmp_path_factory):
    """The JAX test's static-quantized torch net (fbgemm, calibrated on
    seeded noise) and its QDQ export at opset 13."""
    torch.manual_seed(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = jtests._QuantizedNet().eval()
        m.qconfig = torch.ao.quantization.get_default_qconfig("fbgemm")
        torch.ao.quantization.prepare(m, inplace=True)
        for _ in range(4):
            m(torch.randn(2, 3, 16, 16))
        torch.ao.quantization.convert(m, inplace=True)
        x = np.random.default_rng(36).normal(
            size=(2, 3, 16, 16)).astype(np.float32)
        path = tmp_path_factory.mktemp("q") / "q.onnx"
        export_onnx(m, path, torch.from_numpy(x), opset=13)
        with torch.no_grad():
            want = m(torch.from_numpy(x)).numpy()
    return m, x, want, str(path)


def test_quantized_model_qdq_export_parity(quantized_export):
    """The QDQ export through the port: within one quantum of the torch
    quantized (fbgemm integer-kernel) forward at the output scale, the
    JAX test's bar, and within 1e-6 of JAX's executor."""
    m, x, want, path = quantized_export
    graph = pr.read_onnx_graph(path)
    assert {"QuantizeLinear", "DequantizeLinear"} <= {
        n.op_type for n in graph.nodes}
    got = px.GraphExecutor(graph)(x)[0].numpy()
    out_scale = float(m.fc.scale) if hasattr(m.fc, "scale") else 0.1
    np.testing.assert_allclose(got, want, atol=out_scale * 1.001)
    jgot = jax.jit(jx.GraphExecutor(jr.read_onnx_graph(path)))(x)[0]
    np.testing.assert_allclose(got, np.asarray(jgot), atol=1e-6)


def test_qdq_weights_fold_once_into_float_buffers(quantized_export):
    """The build turns each int8 weight -> DequantizeLinear pair into a
    float32 buffer: a call quantizes and dequantizes activations only,
    copies nothing from the host, and a deep copy carries the buffers."""
    _, x, _, path = quantized_export
    ex = px.GraphExecutor(pr.read_onnx_graph(path))
    dq = [n for n in ex.graph.nodes if n.op_type == "DequantizeLinear"]
    run = {id(n) for n in ex._nodes}
    weights = [n for n in dq if id(n) not in run]
    activations = [n for n in dq if id(n) in run]
    assert len(weights) >= 4 and activations
    assert all(n.inputs[0] not in ex._static for n in activations)
    for n in weights:
        assert ex._static[n.outputs[0]].dtype == np.float32
        assert n.outputs[0] in ex._buffer_of  # a registered buffer
    got = ex(torch.from_numpy(x))[0]
    assert ex.host_copies == 0
    assert torch.equal(copy.deepcopy(ex)(torch.from_numpy(x))[0], got)
