"""The port's ONNX reader and graph executor against the JAX package's
(``models/onnx_reader.py``, ``models/onnx_exec.py``).

The reader must give the same graph as JAX's on every export and raise the
same exception on garbage and on mutated files. The executor's ops are
held against the JAX ops on the same NumPy inputs: every one of the 78
ops of the convolutional slice (the rest of the table is in
``test_torch_port_onnx_{ops_rest,quant,control}.py``), the op-level oracles of
``tests/test_onnx_exec_ops.py`` that use only those ops, the exports of
that file's torch modules and of ``tests/model_zoo_torch.py``, all under
the JAX tests' tolerances. An op in neither table raises when the
executor is built, with JAX's message.
"""

import copy

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from infercam_onnx_tpu.models import onnx_exec as jx  # noqa: E402
from infercam_onnx_tpu.models import onnx_reader as jr  # noqa: E402
from infercam_onnx_tpu_torch.models import onnx_exec as px  # noqa: E402
from infercam_onnx_tpu_torch.models import onnx_reader as pr  # noqa: E402

import test_onnx_exec_ops as jtests  # noqa: E402  (its torch modules)
from onnx_export_util import export_onnx  # noqa: E402
from tests import model_zoo_torch as zoo  # noqa: E402
from torch_twin import UltraFaceTwin  # noqa: E402


def _nodes(op, attrs=None, n_out=1):
    """The same node for each package: (JAX's, the port's)."""
    def make(cls):
        return cls(op, f"t_{op}", [], [f"o{i}" for i in range(n_out)],
                   copy.deepcopy(attrs or {}))
    return make(jr.OnnxNode), make(pr.OnnxNode)


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _assert_same(got, want, atol, rtol=1e-5):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            assert np.issubdtype(g.dtype, np.floating)
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32),
                                       atol=atol, rtol=rtol)
        else:
            assert g.dtype.kind == w.dtype.kind or {g.dtype.kind,
                                                    w.dtype.kind} <= {"i",
                                                                      "u"}
            np.testing.assert_array_equal(g, w)


def _both_ops(op, attrs, args, n_out=1):
    jn, pn = _nodes(op, attrs, n_out)
    return px._OPS[op](pn, *args), jx._OPS[op](jn, *args)


# -- every op of the slice, against the JAX op ----------------------------

_R = np.random.default_rng(100)


def _f(*shape, lo=-2.0, hi=2.0):
    return _R.uniform(lo, hi, size=shape).astype(np.float32)


def _i(*vals):
    return np.array(vals, np.int64)


X4 = _f(2, 3, 9, 8)
W3 = _f(4, 3, 3, 3)
POS = _f(2, 3, 4, lo=0.1, hi=3.0)
A, B = _f(2, 3, 4), _f(2, 3, 4)
INTS_A, INTS_B = _i(50, -50, 7, -7, 9), _i(3, 3, -2, -2, -9)
BOOL_A = _R.uniform(size=(3, 4)) > 0.5
BOOL_B = _R.uniform(size=(3, 4)) > 0.5

# (op, attrs, args, n_out, atol)
OP_CASES = {
    "Conv": ("Conv", dict(strides=[2, 1], pads=[1, 0, 2, 1],
                          dilations=[1, 2]), (X4, W3, _f(4)), 1, 1e-5),
    "Conv_group": ("Conv", dict(group=3, pads=[1, 1, 1, 1]),
                   (X4, _f(6, 1, 3, 3)), 1, 1e-5),
    "Conv_same_upper": ("Conv", dict(auto_pad=b"SAME_UPPER",
                                     strides=[2, 2]), (X4, W3), 1, 1e-5),
    "Conv_same_lower": ("Conv", dict(auto_pad=b"SAME_LOWER",
                                     strides=[2, 2]), (X4, W3), 1, 1e-5),
    "Conv_valid": ("Conv", dict(auto_pad=b"VALID"), (X4, W3), 1, 1e-5),
    "BatchNormalization": ("BatchNormalization", dict(epsilon=1e-3),
                           (X4, _f(3), _f(3), _f(3), _f(3, lo=0.5, hi=2)),
                           1, 1e-5),
    "Relu": ("Relu", {}, (A,), 1, 0),
    "Add": ("Add", {}, (A, B), 1, 0),
    "Sub": ("Sub", {}, (A, B[0]), 1, 0),
    "Mul": ("Mul", {}, (A, np.float32(3.0)), 1, 0),
    "Div": ("Div", {}, (A, POS), 1, 1e-6),
    "Div_int": ("Div", {}, (INTS_A, INTS_B), 1, 0),
    "Exp": ("Exp", {}, (A,), 1, 1e-6),
    "Sqrt": ("Sqrt", {}, (POS,), 1, 1e-6),
    "Sigmoid": ("Sigmoid", {}, (A,), 1, 1e-6),
    "Identity": ("Identity", {}, (A,), 1, 0),
    "Concat": ("Concat", dict(axis=1), (A, B, A), 1, 0),
    "Transpose": ("Transpose", dict(perm=[2, 0, 1]), (A,), 1, 0),
    "Transpose_default": ("Transpose", {}, (A,), 1, 0),
    "Reshape": ("Reshape", {}, (A, _i(0, -1, 2)), 1, 0),
    "Flatten": ("Flatten", dict(axis=2), (X4,), 1, 0),
    "Shape": ("Shape", dict(start=1), (X4,), 1, 0),
    "Gather": ("Gather", dict(axis=1), (A, _i(2, -1, 0)), 1, 0),
    "Gather_scalar": ("Gather", {}, (_i(4, 5, 6), np.int64(-2)), 1, 0),
    "Unsqueeze": ("Unsqueeze", {}, (A, _i(0, 3)), 1, 0),
    "Unsqueeze_attr": ("Unsqueeze", dict(axes=[1]), (A,), 1, 0),
    "Squeeze": ("Squeeze", {}, (A[:, :1], _i(1)), 1, 0),
    "Cast": ("Cast", dict(to=7), (A * 3,), 1, 0),
    "Cast_float": ("Cast", dict(to=1), (INTS_A,), 1, 0),
    "Softmax": ("Softmax", dict(axis=1), (A,), 1, 1e-6),
    "Slice": ("Slice", {}, (X4, _i(1, 0), _i(3, 100), _i(2, 3),
                            _i(1, 2)), 1, 0),
    "Slice_backwards": ("Slice", {}, (X4, _i(-1), _i(-2 ** 62), _i(2),
                                      _i(-2)), 1, 0),
    "Slice_attrs": ("Slice", dict(starts=[1], ends=[3], axes=[1]), (A,),
                    1, 0),
    "MaxPool": ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2],
                                pads=[1, 0, 1, 0]), (X4,), 1, 0),
    "MaxPool_indices": ("MaxPool", dict(kernel_shape=[2, 2],
                                        strides=[2, 2], ceil_mode=1),
                        (X4,), 2, 0),
    "MaxUnpool": ("MaxUnpool", dict(kernel_shape=[2, 2], strides=[2, 2]),
                  (_f(1, 2, 3, 3), _i(*range(0, 72, 4)).reshape(1, 2, 3, 3)),
                  1, 0),
    "AveragePool": ("AveragePool", dict(kernel_shape=[3, 2],
                                        strides=[2, 2], pads=[1, 1, 1, 0]),
                    (X4,), 1, 1e-6),
    "AveragePool_include_pad": ("AveragePool", dict(
        kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
        count_include_pad=1), (X4,), 1, 1e-6),
    "AveragePool_dilated": ("AveragePool", dict(
        kernel_shape=[2, 2], dilations=[2, 2]), (X4,), 1, 1e-6),
    "Clip": ("Clip", {}, (A, np.float32(-0.5), np.float32(0.7)), 1, 0),
    "Clip_attrs": ("Clip", dict(min=-1.0), (A,), 1, 0),
    "Constant": ("Constant", dict(value=_f(2, 2)), (), 1, 0),
    "Gemm": ("Gemm", dict(alpha=0.5, beta=2.0, transB=1),
             (_f(3, 4), _f(5, 4), _f(5)), 1, 1e-5),
    "Gemm_transA": ("Gemm", dict(transA=1), (_f(4, 3), _f(4, 5)), 1, 1e-5),
    "MatMul": ("MatMul", {}, (_f(2, 3, 4), _f(2, 4, 5)), 1, 1e-5),
    "GlobalAveragePool": ("GlobalAveragePool", {}, (X4,), 1, 1e-6),
    "GlobalMaxPool": ("GlobalMaxPool", {}, (X4,), 1, 0),
    "ConvTranspose": ("ConvTranspose", dict(strides=[2, 2],
                                            pads=[1, 0, 0, 1],
                                            output_padding=[1, 1], group=3),
                      (_f(1, 6, 4, 5), _f(6, 2, 3, 3), _f(6)), 1, 1e-5),
    "ConvTranspose_dilated": ("ConvTranspose", dict(dilations=[2, 1]),
                              (_f(1, 3, 4, 5), _f(3, 2, 3, 3)), 1, 1e-5),
    "Pad": ("Pad", dict(mode=b"constant"),
            (X4, _i(0, 0, 1, 2, 0, 0, 2, 1), np.float32(1.5)), 1, 0),
    "Pad_reflect": ("Pad", dict(mode=b"reflect"),
                    (X4, _i(0, 0, 2, 1, 0, 0, 1, 3)), 1, 0),
    "Pad_edge_axes": ("Pad", dict(mode=b"edge"),
                      (A, _i(2, 2), None, _i(1)), 1, 0),
    "Pad_wrap": ("Pad", dict(mode=b"wrap"), (A, _i(0, 1, 2, 0, 2, 1)),
                 1, 0),
    "Pad_crop": ("Pad", dict(mode=b"constant"),
                 (np.arange(16, dtype=np.float32).reshape(4, 4),
                  _i(-1, 1, -1, 0)), 1, 0),
    "Pad_legacy": ("Pad", dict(mode=b"constant",
                               pads=[0, 0, 1, 1, 0, 0, 1, 1], value=3.0),
                   (np.ones((1, 1, 2, 2), np.float32),), 1, 0),
    "Resize": ("Resize", dict(mode=b"linear",
                              coordinate_transformation_mode=b"half_pixel"),
               (X4, None, None, _i(2, 3, 17, 13)), 1, 1e-5),
    "Upsample": ("Upsample", dict(mode=b"nearest"),
                 (X4, np.array([1, 1, 2, 2], np.float32)), 1, 0),
    "Upsample_legacy": ("Upsample", dict(mode=b"nearest",
                                         scales=[1.0, 1.0, 2.0, 3.0]),
                        (X4,), 1, 0),
    "Split": ("Split", dict(axis=1), (np.arange(10, dtype=np.float32)[None],
                                      _i(3, 7)), 2, 0),
    "Split_num_outputs": ("Split", dict(axis=0, num_outputs=3),
                          (np.arange(10, dtype=np.float32),), 3, 0),
    "Split_zero_tail": ("Split", dict(axis=0, num_outputs=4),
                        (np.arange(5, dtype=np.float32),), 4, 0),
    "Dropout": ("Dropout", {}, (A,), 2, 0),
    "LRN": ("LRN", dict(size=5, alpha=2e-4, beta=0.7, bias=1.5),
            (_f(2, 12, 7, 6),), 1, 1e-5),
    "DepthToSpace": ("DepthToSpace", dict(blocksize=2, mode=b"DCR"),
                     (_f(2, 12, 2, 3),), 1, 0),
    "DepthToSpace_crd": ("DepthToSpace", dict(blocksize=2, mode=b"CRD"),
                         (_f(2, 12, 2, 3),), 1, 0),
    "SpaceToDepth": ("SpaceToDepth", dict(blocksize=2), (_f(2, 3, 4, 6),),
                     1, 0),
    "ConstantOfShape": ("ConstantOfShape",
                        dict(value=np.array([7.0], np.float32)),
                        (_i(2, 3),), 1, 0),
    "Expand": ("Expand", {}, (_f(3, 1), _i(2, 3, 4)), 1, 0),
    "ReduceMean": ("ReduceMean", dict(axes=[1, 2]), (X4,), 1, 1e-6),
    "ReduceSum": ("ReduceSum", dict(keepdims=0), (A, _i(2)), 1, 1e-6),
    "ReduceSum_noop": ("ReduceSum", dict(noop_with_empty_axes=1),
                       (A, _i()), 1, 0),
    "ReduceMax": ("ReduceMax", dict(keepdims=0), (A, _i(2)), 1, 0),
    "ReduceMin": ("ReduceMin", {}, (A,), 1, 0),
    "ReduceProd": ("ReduceProd", dict(axes=[0, 2]), (A,), 1, 1e-5),
    "LeakyRelu": ("LeakyRelu", dict(alpha=0.1), (A,), 1, 0),
    "PRelu": ("PRelu", {}, (X4, _f(3, 1, 1)), 1, 0),
    "PRelu_channel": ("PRelu", {}, (X4, _f(3)), 1, 0),
    "Elu": ("Elu", dict(alpha=0.7), (A,), 1, 1e-6),
    "Selu": ("Selu", {}, (A,), 1, 1e-6),
    "Tanh": ("Tanh", {}, (A,), 1, 1e-6),
    "Erf": ("Erf", {}, (A,), 1, 1e-6),
    "HardSigmoid": ("HardSigmoid", dict(alpha=0.3), (A,), 1, 1e-6),
    "HardSwish": ("HardSwish", {}, (A * 3,), 1, 1e-6),
    "Softplus": ("Softplus", {}, (A * 10,), 1, 1e-5),
    "Pow": ("Pow", {}, (POS, np.float32(1.5)), 1, 1e-5),
    "Neg": ("Neg", {}, (A,), 1, 0),
    "Abs": ("Abs", {}, (A,), 1, 0),
    "Floor": ("Floor", {}, (A,), 1, 0),
    "Ceil": ("Ceil", {}, (A,), 1, 0),
    "Reciprocal": ("Reciprocal", {}, (POS,), 1, 1e-6),
    "Log": ("Log", {}, (POS,), 1, 1e-6),
    "Min": ("Min", {}, (A, B, B[0]), 1, 0),
    "Max": ("Max", {}, (A, B), 1, 0),
    "Where": ("Where", {}, (A > B, A, B), 1, 0),
    "Equal": ("Equal", {}, (INTS_A, INTS_B * 0 + 7), 1, 0),
    "Greater": ("Greater", {}, (A, B), 1, 0),
    "GreaterOrEqual": ("GreaterOrEqual", {}, (A, A), 1, 0),
    "Less": ("Less", {}, (A, B), 1, 0),
    "LessOrEqual": ("LessOrEqual", {}, (A, B), 1, 0),
    "Not": ("Not", {}, (BOOL_A,), 1, 0),
    "And": ("And", {}, (BOOL_A, BOOL_B), 1, 0),
    "Or": ("Or", {}, (BOOL_A, BOOL_B), 1, 0),
    "ArgMax": ("ArgMax", dict(axis=1, keepdims=0), (A,), 1, 0),
    "ArgMax_last": ("ArgMax", dict(axis=1, select_last_index=1,
                                   keepdims=0),
                    (np.array([[3.0, 1.0, 3.0, 2.0], [0.0, 5.0, 5.0, 5.0]],
                              np.float32),), 1, 0),
    "ArgMin": ("ArgMin", dict(axis=0), (A,), 1, 0),
    "ArgMin_last": ("ArgMin", dict(axis=0, select_last_index=1),
                    (np.array([[3.0, 1.0, 3.0, 2.0], [0.0, 5.0, 5.0, 5.0]],
                              np.float32),), 1, 0),
    "Range": ("Range", {}, (np.int64(2), np.int64(11), np.int64(3)), 1, 0),
    "Tile": ("Tile", {}, (_f(2, 3), _i(2, 3)), 1, 0),
}


def test_op_cases_cover_the_whole_op_set():
    """The port's table is the JAX table, all 127 ops: the convolutional
    slice has a case below, the rest in
    tests/test_torch_port_onnx_ops_rest.py, the quantized family in
    tests/test_torch_port_onnx_quant.py."""
    from test_torch_port_onnx_ops_rest import REST_CASES
    from test_torch_port_onnx_quant import QUANT_CASES

    assert set(px._OPS) == set(jx._OPS) and len(px._OPS) == 127
    covered = {case[0] for cases in (OP_CASES, REST_CASES, QUANT_CASES)
               for case in cases.values()}
    assert covered == set(px._OPS)
    assert len({case[0] for case in OP_CASES.values()}) == 78


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_matches_jax(name):
    op, attrs, args, n_out, atol = OP_CASES[name]
    got, want = _both_ops(op, attrs, args, n_out)
    _assert_same(got, want, atol)


# inputs a graph always hands an op as NumPy (shapes, axes, pads,
# geometry: computed on the host by the shape math)
SHAPE_INPUTS = {
    "Shape": (0,), "Reshape": (1,), "Unsqueeze": (1,), "Squeeze": (1,),
    "Slice": (1, 2, 3, 4), "MaxUnpool": (2,), "Clip": (1, 2),
    "Pad": (1, 2, 3), "Resize": (1, 2, 3), "Upsample": (1,), "Split": (1,),
    "Dropout": (1, 2), "ConstantOfShape": (0,), "Expand": (1,),
    "ReduceMean": (1,), "ReduceSum": (1,), "ReduceMax": (1,),
    "ReduceMin": (1,), "ReduceProd": (1,), "Range": (0, 1, 2), "Tile": (1,),
    "TopK": (1,), "NonMaxSuppression": (2, 3, 4), "Trilu": (1,),
    "OneHot": (1,), "SequenceInsert": (2,), "SequenceErase": (1,),
    "SequenceAt": (1,), "CumSum": (1,), "ReduceL1": (1,), "ReduceL2": (1,),
    "ReduceLogSumExp": (1,),
}


@pytest.mark.parametrize("name", [
    "Add", "Mul", "Div", "Conv", "Conv_same_upper", "Relu", "MatMul",
    "Gather", "Pow", "Slice", "Slice_backwards", "Pad", "Pad_reflect",
    "Pad_wrap", "Resize", "MaxPool_indices", "AveragePool",
    "AveragePool_dilated", "ConvTranspose", "Softmax", "Expand", "Tile",
    "ReduceProd", "ArgMax_last", "Split_num_outputs", "Concat",
    "Transpose", "DepthToSpace", "Cast", "Clip", "Where", "Min",
    "GlobalMaxPool", "Dropout", "LRN", "BatchNormalization", "Gemm"])
def test_op_on_tensors_matches_jax(name):
    """The same cases with their data as tensors, the form a graph run
    hands the ops (NumPy inputs stay NumPy where every input is)."""
    op, attrs, args, n_out, atol = OP_CASES[name]
    keep = SHAPE_INPUTS.get(op, ())
    targs = [torch.from_numpy(np.array(a)) if i not in keep
             and isinstance(a, np.ndarray) and a.dtype != np.int64 else a
             for i, a in enumerate(args)]
    _, pn = _nodes(op, attrs, n_out)
    got = px._OPS[op](pn, *targs)
    assert isinstance(_as_list(got)[0], torch.Tensor)
    jn, _ = _nodes(op, attrs, n_out)
    _assert_same(got, jx._OPS[op](jn, *args), atol)


# -- the op-level oracles of tests/test_onnx_exec_ops.py ------------------

def _resize_x():
    return np.random.default_rng(7).normal(
        size=(1, 3, 10, 12)).astype(np.float32)


RESIZE_MODES = [
    dict(mode=b"nearest", coordinate_transformation_mode=b"asymmetric",
         nearest_mode=b"floor"),
    dict(mode=b"linear", coordinate_transformation_mode=b"half_pixel"),
    dict(mode=b"linear", coordinate_transformation_mode=b"align_corners"),
    dict(mode=b"cubic", coordinate_transformation_mode=b"half_pixel"),
    dict(mode=b"cubic", coordinate_transformation_mode=b"align_corners"),
    dict(mode=b"nearest", coordinate_transformation_mode=b"half_pixel",
         nearest_mode=b"round_prefer_ceil"),
    dict(mode=b"linear",
         coordinate_transformation_mode=b"pytorch_half_pixel"),
]


@pytest.mark.parametrize("attrs", RESIZE_MODES,
                         ids=lambda a: "-".join(v.decode() for v in
                                                a.values()))
def test_resize_matches_torch_interpolate_modes(attrs):
    got, want = _both_ops("Resize", attrs, (_resize_x(), None, None,
                                            _i(1, 3, 25, 30)))
    _assert_same(got, want, 1e-5)


def test_resize_cubic_coeff_a():
    ramp = np.tile(np.arange(12, dtype=np.float32), (10, 1))[None, None]
    for a, coord in ((-0.5, b"align_corners"), (-0.75, b"half_pixel"),
                     (-0.5, b"half_pixel")):
        x = ramp if coord == b"align_corners" else np.random.default_rng(
            40).normal(size=(1, 2, 10, 12)).astype(np.float32)
        got, want = _both_ops("Resize", dict(
            mode=b"cubic", cubic_coeff_a=a,
            coordinate_transformation_mode=coord),
            (x, None, None, _i(1, x.shape[1], 19, 23)))
        _assert_same(got, want, 1e-5)


def test_resize_axes_attribute():
    got, want = _both_ops("Resize", dict(
        mode=b"linear", coordinate_transformation_mode=b"half_pixel",
        axes=[2, 3]), (_resize_x(), None, None, _i(20, 24)))
    _assert_same(got, want, 1e-5)


def test_resize_downscale_nearest():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got, want = _both_ops("Resize", dict(
        mode=b"nearest", coordinate_transformation_mode=b"asymmetric",
        nearest_mode=b"floor"),
        (x, None, np.array([1, 1, 0.5, 0.5], np.float32), None))
    _assert_same(got, want, 0)
    np.testing.assert_array_equal(np.asarray(got), x[:, :, ::2, ::2])


def test_resize_opset10_two_input_form():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got, want = _both_ops("Resize", dict(mode=b"nearest", _opset=10),
                          (x, np.array([1, 1, 2, 2], np.float32)))
    _assert_same(got, want, 0)


@pytest.mark.parametrize("mode,a,coord", [
    ("linear", -0.75, b"pytorch_half_pixel"),
    ("cubic", -0.5, b"pytorch_half_pixel"),
    ("linear", -0.75, b"align_corners"), ("cubic", -0.5, b"align_corners"),
])
def test_resize_antialias_matches_torch(mode, a, coord):
    x = np.random.default_rng(46).normal(size=(2, 3, 17, 23)).astype(
        np.float32)
    got, want = _both_ops("Resize", dict(
        mode=mode.encode(), antialias=1, cubic_coeff_a=a,
        coordinate_transformation_mode=coord),
        (x, None, None, _i(2, 3, 7, 9)))
    _assert_same(got, want, 1e-4 if coord == b"align_corners" else 1e-5)


@pytest.mark.parametrize("attrs, sizes", [
    (dict(mode=b"linear", coordinate_transformation_mode=b"half_pixel",
          antialias=1), (1, 1, 10, 12)),
    (dict(mode=b"cubic", coordinate_transformation_mode=b"half_pixel",
          exclude_outside=1), (1, 1, 12, 12)),
    (dict(mode=b"linear", coordinate_transformation_mode=b"asymmetric",
          exclude_outside=1), (1, 1, 4, 4)),
], ids=["antialias_upscale_is_noop", "exclude_outside_cubic",
        "exclude_outside_linear"])
def test_resize_antialias_and_exclude_outside(attrs, sizes):
    x = np.random.default_rng(49).normal(size=(1, 1, 6, 6) if sizes[2] != 4
                                         else (1, 1, 8, 8)).astype(
        np.float32)
    got, want = _both_ops("Resize", attrs, (x, None, None, _i(*sizes)))
    _assert_same(got, want, 1e-5)


def test_upsample_legacy_op():
    x = np.random.default_rng(8).normal(size=(1, 2, 3, 4)).astype(
        np.float32)
    got, want = _both_ops("Upsample", dict(mode=b"nearest"),
                          (x, np.array([1, 1, 2, 2], np.float32)))
    _assert_same(got, want, 0)


def test_batch_norm_spatial0_fails_loudly():
    args = (np.zeros((1, 2, 3, 3), np.float32), np.ones(2, np.float32),
            np.zeros(2, np.float32), np.zeros(2, np.float32),
            np.ones(2, np.float32))
    jn, pn = _nodes("BatchNormalization", dict(spatial=0))
    with pytest.raises(ValueError, match="spatial"):
        jx._OPS["BatchNormalization"](jn, *args)
    with pytest.raises(ValueError, match="spatial"):
        px._OPS["BatchNormalization"](pn, *args)


def test_dilated_maxpool_matches_torch():
    x = np.random.default_rng(34).normal(size=(1, 2, 9, 9)).astype(
        np.float32)
    got, want = _both_ops("MaxPool", dict(kernel_shape=[3, 3],
                                          strides=[1, 1],
                                          dilations=[2, 2]), (x,))
    _assert_same(got, want, 0)


@pytest.mark.parametrize("op, attrs", [
    ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2], ceil_mode=1)),
    ("MaxPool", dict(kernel_shape=[2, 2], strides=[2, 2],
                     pads=[1, 1, 1, 1], ceil_mode=1)),
    ("AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2],
                         ceil_mode=1)),
    ("AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2],
                         pads=[1, 1, 1, 1], ceil_mode=1,
                         count_include_pad=1)),
    ("AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2],
                         pads=[1, 1, 1, 1], ceil_mode=1)),
])
def test_ceil_mode_pools_match_torch(op, attrs):
    x = np.random.default_rng(42).normal(size=(1, 2, 7, 9)).astype(
        np.float32)
    got, want = _both_ops(op, attrs, (x,))
    _assert_same(got, want, 1e-6)
    tx = torch.from_numpy(x)
    pads = attrs.get("pads", [0] * 4)[0]
    if op == "MaxPool":
        oracle = torch.nn.functional.max_pool2d(
            tx, attrs["kernel_shape"], attrs["strides"], padding=pads,
            ceil_mode=True)
    else:
        oracle = torch.nn.functional.avg_pool2d(
            tx, 3, 2, padding=pads, ceil_mode=True,
            count_include_pad=bool(attrs.get("count_include_pad", 0)))
    np.testing.assert_allclose(np.asarray(got), oracle.numpy(), atol=1e-6)


def test_integer_div_truncates_like_c():
    got, want = _both_ops("Div", {}, (_i(50, -50, 7, -7), _i(3, 3, -2, -2)))
    _assert_same(got, want, 0)
    np.testing.assert_array_equal(np.asarray(got), [16, -16, -3, 3])
    # the same on int64 tensors, and floats keep true division
    _, pn = _nodes("Div")
    t = px._OPS["Div"](pn, torch.tensor([50, -50, 7, -7]),
                       torch.tensor([3, 3, -2, -2]))
    assert t.dtype == torch.int64
    assert t.tolist() == [16, -16, -3, 3]
    assert float(px._OPS["Div"](pn, np.float32(1.0),
                                np.float32(4.0))) == 0.25


def test_conv_and_pool_auto_pad_matches_torch_same():
    rng = np.random.default_rng(22)
    x = rng.normal(size=(1, 2, 8, 8)).astype(np.float32)
    w = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    for mode, pad in ((b"SAME_UPPER", ((0, 1), (0, 1))),
                      (b"SAME_LOWER", ((1, 0), (1, 0)))):
        got, want = _both_ops("Conv", dict(auto_pad=mode, strides=[2, 2]),
                              (x, w))
        _assert_same(got, want, 1e-5)
        oracle = torch.nn.functional.conv2d(
            torch.from_numpy(np.pad(x, ((0, 0), (0, 0)) + pad)),
            torch.from_numpy(w), stride=2)
        np.testing.assert_allclose(np.asarray(got), oracle.numpy(),
                                   atol=1e-5)
    got, want = _both_ops("MaxPool", dict(auto_pad=b"SAME_UPPER",
                                          kernel_shape=[3, 3],
                                          strides=[2, 2]), (x,))
    _assert_same(got, want, 0)
    assert got.shape == (1, 2, 4, 4)


def test_conv_transpose_output_shape_and_same():
    rng = np.random.default_rng(57)
    x = rng.normal(size=(1, 3, 5, 6)).astype(np.float32)
    w = rng.normal(size=(3, 4, 3, 3)).astype(np.float32)
    for attrs, shape in (
            (dict(kernel_shape=[3, 3], strides=[2, 2],
                  output_shape=[9, 11]), (1, 4, 9, 11)),
            (dict(kernel_shape=[3, 3], strides=[2, 2],
                  output_shape=[10, 12]), (1, 4, 10, 12)),
            (dict(kernel_shape=[3, 3], strides=[2, 2],
                  output_shape=[10, 12], auto_pad=b"SAME_UPPER"),
             (1, 4, 10, 12)),
            (dict(kernel_shape=[3, 3], strides=[2, 2],
                  auto_pad=b"SAME_UPPER"), (1, 4, 10, 12)),
            (dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 0, 0]),
             (1, 4, 10, 12))):
        got, want = _both_ops("ConvTranspose", attrs, (x, w))
        assert tuple(got.shape) == shape
        _assert_same(got, want, 1e-5)


def test_maxpool_indices_are_onnx_global_flat():
    x = np.zeros((2, 2, 4, 4), np.float32)
    x[0, 0, 1, 2] = 5.0
    x[1, 1, 3, 3] = 7.0
    got, want = _both_ops("MaxPool", dict(kernel_shape=[2, 2],
                                          strides=[2, 2]), (x,), n_out=2)
    _assert_same(got, want, 0)
    idx = np.asarray(got[1])
    assert idx[0, 0, 0, 1] == 6 and idx[1, 1, 1, 1] == 48 + 15
    assert idx[0, 0, 0, 0] == 0 and idx[0, 1, 0, 0] == 16


def test_maxpool_indices_all_neg_inf_window_stays_valid():
    x = np.full((1, 1, 4, 4), -np.inf, np.float32)
    got, want = _both_ops("MaxPool", dict(kernel_shape=[3, 3],
                                          strides=[2, 2],
                                          pads=[1, 1, 1, 1]), (x,), n_out=2)
    _assert_same(got[1], want[1], 0)
    _, tidx = torch.nn.functional.max_pool2d(
        torch.from_numpy(x), 3, 2, padding=1, return_indices=True)
    np.testing.assert_array_equal(np.asarray(got[1]), tidx.numpy())


def test_max_unpool_roundtrip_node():
    x = np.random.default_rng(52).normal(size=(1, 2, 6, 6)).astype(
        np.float32)
    jn, pn = _nodes("MaxPool", dict(kernel_shape=[2, 2], strides=[2, 2]),
                    n_out=2)
    vals, idx = (np.asarray(v) for v in jx._OPS["MaxPool"](jn, x))
    got, want = _both_ops("MaxUnpool", dict(kernel_shape=[2, 2],
                                            strides=[2, 2]), (vals, idx))
    _assert_same(got, want, 0)
    oracle = torch.nn.functional.max_unpool2d(
        torch.from_numpy(np.array(vals)),
        torch.from_numpy(idx.astype(np.int64) % 36), 2, stride=2)
    np.testing.assert_array_equal(np.asarray(got), oracle.numpy())


def test_legacy_attribute_forms_pad_and_upsample():
    x = np.ones((1, 1, 2, 2), np.float32)
    got, want = _both_ops("Pad", dict(mode=b"constant",
                                      pads=[0, 0, 1, 1, 0, 0, 1, 1],
                                      value=3.0), (x,))
    _assert_same(got, want, 0)
    got, want = _both_ops("Upsample", dict(mode=b"nearest",
                                           scales=[1.0, 1.0, 2.0, 2.0]),
                          (x,))
    _assert_same(got, want, 0)


def _graph(module, nodes, inits, inputs, outputs, opset):
    """The same hand-built graph in one package's reader classes."""
    return module.OnnxGraph(
        nodes=[module.OnnxNode(*n) for n in nodes],
        initializers=dict(inits),
        inputs=[module.OnnxValueInfo(*i) for i in inputs],
        outputs=[module.OnnxValueInfo(*o) for o in outputs], opset=opset)


def _graphs(nodes, inits, inputs, outputs, opset=13):
    return (_graph(jr, copy.deepcopy(nodes), inits, inputs, outputs, opset),
            _graph(pr, copy.deepcopy(nodes), inits, inputs, outputs, opset))


@pytest.mark.parametrize("opset", [11, 13])
def test_softmax_pre13_flattened_semantics(opset):
    """Opset < 13 Softmax is a flattened-2D softmax over dims[axis:]; the
    executor reads the model opset."""
    x = np.random.default_rng(40).normal(size=(2, 3, 4)).astype(np.float32)
    jg, pg = _graphs([("Softmax", "s", ["x"], ["y"], {"axis": 1})], {},
                     [("x", 1, [2, 3, 4])], [("y", 1, [2, 3, 4])], opset)
    got, want = px.GraphExecutor(pg)(x)[0], jx.GraphExecutor(jg)(x)[0]
    _assert_same(got, want, 1e-6)
    sums = np.asarray(got).reshape(2, -1).sum(-1) if opset < 13 \
        else np.asarray(got).sum(1)
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


def test_unsupported_op_fails_loudly_at_build(tmp_path):
    """TopK (exported by torch) builds and runs in both executors, equal;
    an op in neither table raises at build in both, with JAX's message
    (no op of JAX's table raises)."""
    path = tmp_path / "topk.onnx"
    export_onnx(jtests._TopKNet(), path, torch.zeros(2, 6), opset=11)
    x = np.random.default_rng(11).normal(size=(2, 6)).astype(np.float32)
    got = px.GraphExecutor(pr.read_onnx_graph(str(path)))(x)
    _assert_same(got, jx.GraphExecutor(jr.read_onnx_graph(str(path)))(x), 0)
    jg, pg = _graphs([("FooOp", "foo", ["x"], ["y"], {})], {},
                     [("x", 1, [1])], [("y", 1, [1])])
    with pytest.raises(ValueError) as jerr:
        jx.GraphExecutor(jg)
    with pytest.raises(ValueError) as perr:
        px.GraphExecutor(pg)
    assert str(perr.value) == str(jerr.value)
    assert str(perr.value).startswith("unsupported ONNX op 'FooOp'")


@pytest.mark.parametrize("op", ["If", "Loop", "Scan"])
def test_control_flow_fails_at_build(op):
    """If/Loop/Scan build now; a malformed one (here a body with no
    inputs or outputs) fails at build with the JAX executor's message."""
    def graph(m):
        body = m.OnnxGraph(nodes=[], initializers={}, inputs=[], outputs=[],
                           opset=13)
        return m.OnnxGraph(
            nodes=[m.OnnxNode(op, "cf", ["x"], ["y"],
                              {"body": body, "then_branch": body,
                               "else_branch": body})],
            initializers={}, inputs=[m.OnnxValueInfo("x", 1, [1])],
            outputs=[m.OnnxValueInfo("y", 1, [1])], opset=13)

    with pytest.raises(ValueError) as jerr:
        jx.GraphExecutor(graph(jr))
    with pytest.raises(ValueError) as perr:
        px.GraphExecutor(graph(pr))
    assert str(perr.value) == str(jerr.value)
    assert f"{op} node 'cf'" in str(perr.value)


def test_lrn_export_with_if_subgraph_is_a8b(tmp_path):
    """torch's LRN export goes through an If node (ROADMAP A.8b, ported):
    the port runs it, equal to the JAX executor and torch."""
    path = tmp_path / "lrn.onnx"
    export_onnx(jtests._Lrn(), path, torch.zeros(2, 12, 7, 6), opset=11)
    assert any(n.op_type == "If"
               for n in pr.read_onnx_graph(str(path)).nodes)
    x = np.random.default_rng(3).normal(size=(2, 12, 7, 6)).astype(
        np.float32)
    _, got = _both_executors(path, [x], 1e-5)
    np.testing.assert_allclose(got[0].numpy(), jtests._Lrn()(
        torch.from_numpy(x)).numpy(), atol=1e-5)


def test_graph_validation_errors_equal_jax():
    """A node consuming an unknown value, and a graph output no node
    makes, raise the JAX executor's errors."""
    for nodes, outputs in (
            ([("Relu", "r", ["nope"], ["y"], {})], [("y", 1, [1])]),
            ([("Relu", "r", ["x"], ["y"], {})], [("z", 1, [1])])):
        jg, pg = _graphs(nodes, {}, [("x", 1, [1])], outputs)
        with pytest.raises(ValueError) as jerr:
            jx.GraphExecutor(jg)
        with pytest.raises(ValueError) as perr:
            px.GraphExecutor(pg)
        assert str(perr.value) == str(jerr.value)


# -- constants, dtypes and placement --------------------------------------


def test_float64_constants_keep_float32_data_float32():
    """A float64 initializer times a float32 input stays float32, as in
    the JAX package without x64; int64 shape math stays exact NumPy."""
    nodes = [("Mul", "m", ["x", "c"], ["y"], {}),
             ("Shape", "s", ["x"], ["sh"], {}),
             ("Mul", "m2", ["sh", "k"], ["sh2"], {})]
    inits = {"c": np.array([0.1, 1e-9, 3.0], np.float64),
             "k": np.array([2 ** 40 + 1], np.int64)}
    jg, pg = _graphs(nodes, inits, [("x", 1, [3])],
                     [("y", 1, [3]), ("sh2", 7, [1])])
    x = np.array([1.5, -2.0, 0.25], np.float32)
    y, sh2 = px.GraphExecutor(pg)(x)
    jy = jax.jit(jx.GraphExecutor(jg))(x)[0]  # the traced form: float32
    jsh2 = jx.GraphExecutor(jg)(x)[1]  # the eager form: exact int64
    assert y.dtype == torch.float32 and np.asarray(jy).dtype == np.float32
    _assert_same(y, jy, 0)
    assert isinstance(sh2, np.ndarray) and sh2.dtype == np.int64
    np.testing.assert_array_equal(sh2, jsh2)
    assert int(sh2[0]) == 3 * (2 ** 40 + 1)


def test_constants_are_buffers_copied_once(tmp_path):
    """The twin export's initializers and Constant nodes are buffers: a
    call copies nothing from the host, the build folds the constant-only
    nodes, and a deep copy (a replica) carries them."""
    torch.manual_seed(3)
    twin = UltraFaceTwin(torch.zeros(4420, 4)).eval()
    path = tmp_path / "twin.onnx"
    export_onnx(twin, path, torch.zeros(1, 3, 240, 320), opset=11,
                input_names=["input"], output_names=["scores", "boxes"])
    ex = px.GraphExecutor(pr.read_onnx_graph(str(path)))
    folded = [n for n in ex.graph.nodes if n.op_type in ("Constant",
                                                         "Identity")]
    assert ex.nodes_run == len(ex.graph.nodes) - len(folded)
    x = np.random.default_rng(7).normal(size=(1, 3, 240, 320)).astype(
        np.float32)
    want = ex(torch.from_numpy(x))
    assert ex.host_copies == 0
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in ex.buffers())
    clone = copy.deepcopy(ex)
    for g, w in zip(clone(torch.from_numpy(x)), want):
        assert torch.equal(g, w)
    jwant = jx.GraphExecutor(jr.read_onnx_graph(str(path)))(x)
    for g, w in zip(want, jwant):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


# -- exports of the JAX op tests' torch modules ---------------------------


def _both_executors(path, inputs, atol, rtol=1e-5):
    pg, jg = pr.read_onnx_graph(str(path)), jr.read_onnx_graph(str(path))
    got = px.GraphExecutor(pg)(*inputs)
    want = jax.jit(jx.GraphExecutor(jg))(*inputs)
    _assert_same(got, want, atol, rtol)
    return pg, got


EXPORTS = {
    # name: (module factory, input shapes, opset, atol, ops it must hold)
    "classifier": (jtests._Classifier, [(2, 3, 32, 32)], 14, 1e-5,
                   {"HardSwish", "LeakyRelu", "AveragePool",
                    "GlobalAveragePool", "Gemm"}),
    "decoder": (jtests._Decoder, [(1, 8, 10, 11)], 11, 1e-4,
                {"ConvTranspose", "PRelu", "Resize", "Pad"}),
    "eltwise": (jtests._Eltwise, [(2, 4, 6, 5), (2, 4, 6, 5)], 13, 1e-5,
                {"Tanh", "Erf", "Elu", "Softplus", "HardSigmoid", "Selu",
                 "Pow", "Clip", "Where", "ReduceMean", "ReduceSum"}),
    "depth_to_space": (jtests._PixelShuffle, [(1, 8, 5, 6)], 11, 1e-5,
                       {"DepthToSpace"}),
    "matmul": (jtests._MatMulNet, [(2, 4, 4), (2, 4, 4)], 11, 1e-5,
               {"MatMul"}),
    "global_max_pool": (jtests._GlobalMax, [(2, 5, 9, 8)], 11, 1e-5,
                        {"MaxPool"}),
    "maxpool_indices": (jtests._PoolIndicesNet, [(2, 3, 8, 10)], 11, 0,
                        {"MaxPool"}),
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_export_matches_jax(name, tmp_path):
    factory, shapes, opset, atol, ops = EXPORTS[name]
    torch.manual_seed(0)
    mod = factory().eval()
    rng = np.random.default_rng(len(name))
    inputs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    path = tmp_path / f"{name}.onnx"
    export_onnx(mod, path, *[torch.from_numpy(i) for i in inputs],
                opset=opset)
    graph, got = _both_executors(path, inputs, atol)
    assert ops <= {n.op_type for n in graph.nodes}
    with torch.no_grad():
        want = mod(*[torch.from_numpy(i) for i in inputs])
    for g, w in zip(_as_list(got), _as_list(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   w.numpy().astype(np.float32),
                                   atol=max(atol, 1e-5), rtol=1e-5)


@pytest.mark.parametrize("model, size, batch, opset", [
    ("ResNet18", 96, 2, 13), ("ResNet18", 64, 1, 17),
    ("MobileNetV2", 96, 2, 13), ("SqueezeNet11", 96, 2, 13),
    ("UNetSmall", 64, 2, 13),
])
def test_model_zoo_matches_jax(model, size, batch, opset, tmp_path):
    """The JAX package's model-zoo oracles (tests/test_onnx_exec_models.py)
    through the port's executor: against JAX's executor and the torch
    forward, atol 1e-4."""
    torch.manual_seed(0)
    mod = getattr(zoo, model)().eval()
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    x = np.random.default_rng(0).normal(
        size=(batch, 3, size, size)).astype(np.float32) * 0.5
    path = tmp_path / "model.onnx"
    export_onnx(mod, path, torch.from_numpy(x), opset=opset)
    _, got = _both_executors(path, [x], 1e-4, 1e-4)
    with torch.no_grad():
        want = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(got[0]), want, atol=1e-4,
                               rtol=1e-4)


# -- the reader -------------------------------------------------------------


def _same_graph(got, want):
    assert type(got).__name__ == type(want).__name__ == "OnnxGraph"
    assert got.opset == want.opset
    assert [(v.name, v.elem_type, v.shape) for v in got.inputs] == \
        [(v.name, v.elem_type, v.shape) for v in want.inputs]
    assert [(v.name, v.elem_type, v.shape) for v in got.outputs] == \
        [(v.name, v.elem_type, v.shape) for v in want.outputs]
    assert list(got.initializers) == list(want.initializers)
    for k, v in want.initializers.items():
        assert got.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(got.initializers[k], v)
    assert len(got.nodes) == len(want.nodes)
    for a, b in zip(got.nodes, want.nodes):
        assert (a.op_type, a.name, a.inputs, a.outputs) == \
            (b.op_type, b.name, b.inputs, b.outputs)
        assert list(a.attrs) == list(b.attrs)
        for k, v in b.attrs.items():
            if isinstance(v, jr.OnnxGraph):
                _same_graph(a.attrs[k], v)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(a.attrs[k], v)
                assert a.attrs[k].dtype == v.dtype
            else:
                assert a.attrs[k] == v


@pytest.fixture(scope="module")
def twin_exports(tmp_path_factory):
    d = tmp_path_factory.mktemp("reader")
    torch.manual_seed(3)
    twin = UltraFaceTwin(torch.zeros(4420, 4)).eval()
    paths = {}
    for fold in (True, False):
        paths[fold] = str(d / f"twin_{fold}.onnx")
        export_onnx(twin, paths[fold], torch.zeros(1, 3, 240, 320),
                    opset=11, fold=fold, input_names=["input"],
                    output_names=["scores", "boxes"])
    paths["lrn"] = str(d / "lrn.onnx")  # with If subgraph attributes
    export_onnx(jtests._Lrn(), paths["lrn"], torch.zeros(2, 12, 7, 6),
                opset=11)
    return paths


@pytest.mark.parametrize("which", [True, False, "lrn"],
                         ids=["folded", "unfolded", "lrn_if_subgraph"])
def test_onnx_reader_same_graph_as_jax(twin_exports, which):
    path = twin_exports[which]
    _same_graph(pr.read_onnx_graph(path), jr.read_onnx_graph(path))
    got, want = pr.read_onnx_initializers(path), \
        jr.read_onnx_initializers(path)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _outcome(read, path):
    try:
        return "ok", read(path)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)


def test_onnx_reader_rejects_garbage_like_jax(tmp_path):
    rng = np.random.default_rng(11)
    for i in range(30):
        path = tmp_path / f"junk{i}.onnx"
        path.write_bytes(bytes(rng.integers(
            0, 256, size=int(rng.integers(0, 4096)), dtype=np.uint8)))
        got = _outcome(pr.read_onnx_graph, str(path))
        want = _outcome(jr.read_onnx_graph, str(path))
        assert got[0] == want[0] == "ValueError"
        assert got[1] == want[1]


def test_onnx_reader_mutation_fuzz_like_jax(twin_exports, tmp_path):
    """Byte flips, truncations and spliced chunks of a valid export: the
    port's reader parses what JAX's parses, to the same graph, and raises
    JAX's exception and message on the rest."""
    data = open(twin_exports[True], "rb").read()
    rng = np.random.default_rng(60)
    for i in range(60):
        blob = bytearray(data)
        kind = i % 3
        if kind == 0:
            blob = blob[:int(rng.integers(1, len(blob)))]
        elif kind == 1:
            for _ in range(int(rng.integers(1, 8))):
                blob[int(rng.integers(0, len(blob)))] = int(
                    rng.integers(0, 256))
        else:
            off = int(rng.integers(0, len(blob) - 16))
            blob[off:off + 16] = bytes(rng.integers(0, 256, size=16,
                                                    dtype=np.uint8))
        path = tmp_path / "mut.onnx"
        path.write_bytes(bytes(blob))
        got = _outcome(pr.read_onnx_graph, str(path))
        want = _outcome(jr.read_onnx_graph, str(path))
        assert got[0] == want[0]
        if got[0] == "ok":
            _same_graph(got[1], want[1])
        else:
            assert got[1] == want[1]
