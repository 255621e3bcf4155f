"""The rest of the port's ONNX op table against the JAX package's
(``models/onnx_exec.py:910-992`` there and its helpers): TopK and
NonMaxSuppression, the norms, Einsum and the elementwise ops, EyeLike,
Trilu, OneHot, GridSample (2-D and 3-D), RoiAlign, the RNN family, the
sequence ops, gather/scatter with reductions, LogSoftmax, CumSum, the
reduce norms and LpNormalization.

Every op runs on the same seeded NumPy inputs through the JAX op and the
port's, on NumPy and on tensors; the op-level oracles of
``tests/test_onnx_exec_ops.py`` and its exports that use these ops run
through both executors, and the CRNN export of
``tests/test_onnx_exec_models.py`` at atol/rtol 1e-4. Tolerances are
stated per case; integer and index results are exact.

Three exports are committed under ``tests/fixtures/`` for the card, which
has no JAX (`chip_smoke.py` ``graph_ops``): ``python
tests/test_torch_port_onnx_ops_rest.py`` writes them again.
"""

import pathlib
import sys

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
from test_torch_port_onnx import (SHAPE_INPUTS, _as_list,  # noqa: E402
                                  _assert_same, _both_ops, _nodes,
                                  _same_graph)
from tests import model_zoo_torch as zoo  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

_R = np.random.default_rng(200)


def _f(*shape, lo=-2.0, hi=2.0):
    return _R.uniform(lo, hi, size=shape).astype(np.float32)


def _i(*vals):
    return np.array(vals, np.int64)


X4 = _f(2, 6, 5, 4)
A = _f(3, 4, 5)
GRID = _f(2, 4, 5, 2, lo=-1.4, hi=1.4)
GRID3 = _f(2, 3, 2, 4, 3, lo=-1.4, hi=1.4)
ROIS = np.array([[1.0, 1.0, 7.0, 5.0], [0.0, 0.0, 3.0, 2.0],
                 [2.0, 0.5, 9.5, 7.5]], np.float32)
SPECIALS = np.array([1.0, np.nan, np.inf, -np.inf, -2.5, 0.0], np.float32)
LSTM_W = _f(2, 4 * 5, 3) * 0.5
LSTM_R = _f(2, 4 * 5, 5) * 0.5
GRU_W, GRU_R = _f(2, 3 * 5, 3) * 0.5, _f(2, 3 * 5, 5) * 0.5
SEQ = _f(4, 2, 3)
SEQ5 = _f(6, 2, 5)  # [seq, batch, input] of _Recurrent
IDX2 = np.array([[0, -1, 1, 0], [2, 0, -2, 1]], np.int64)

# (op, attrs, args, n_out, atol): every op of step 4 at least once
REST_CASES = {
    "TopK": ("TopK", dict(axis=1), (A, np.int64(3)), 2, 0),
    "TopK_smallest": ("TopK", dict(axis=-1, largest=0),
                      (np.array([[4.0, 1.0, 3.0, 1.0]], np.float32),
                       np.int64(3)), 2, 0),
    "TopK_uint8": ("TopK", dict(axis=1), (np.array([[0, 5, 3, 5]], np.uint8),
                                          np.int64(2)), 2, 0),
    "NonMaxSuppression": ("NonMaxSuppression", {}, (
        np.array([[[0, 0, 1, 1], [0, 0.05, 1, 1.05], [0, 2, 1, 3]]],
                 np.float32), np.array([[[0.9, 0.8, 0.7]]], np.float32),
        np.int64(10), np.float32(0.5), np.float32(0.0)), 1, 0),
    "InstanceNormalization": ("InstanceNormalization", dict(epsilon=1e-3),
                              (X4, _f(6), _f(6)), 1, 1e-5),
    "GroupNormalization": ("GroupNormalization", dict(num_groups=3),
                           (X4, _f(6), _f(6)), 1, 1e-5),
    "GroupNormalization_per_group": ("GroupNormalization",
                                     dict(num_groups=3),
                                     (X4, _f(3), _f(3)), 1, 1e-5),
    "LayerNormalization": ("LayerNormalization", dict(axis=-1),
                           (A, _f(5), _f(5)), 1, 1e-5),
    "LayerNormalization_stats": ("LayerNormalization", dict(axis=1),
                                 (A, _f(4, 5)), 3, 1e-5),
    "Einsum": ("Einsum", dict(equation=b"bij,bjk->bik"),
               (A, _f(3, 5, 2)), 1, 1e-5),
    "Shrink": ("Shrink", dict(lambd=0.3, bias=0.3), (A,), 1, 1e-7),
    "IsNaN": ("IsNaN", {}, (SPECIALS,), 1, 0),
    "IsInf": ("IsInf", {}, (SPECIALS,), 1, 0),
    "IsInf_positive": ("IsInf", dict(detect_negative=0), (SPECIALS,), 1, 0),
    "EyeLike": ("EyeLike", dict(k=1), (np.zeros((3, 4), np.float32),), 1, 0),
    "EyeLike_dtype": ("EyeLike", dict(k=-1, dtype=7),
                      (np.zeros((4, 3), np.float32),), 1, 0),
    "Trilu": ("Trilu", dict(upper=0), (A, np.int64(1)), 1, 0),
    "Trilu_upper": ("Trilu", {}, (A,), 1, 0),
    "OneHot": ("OneHot", {}, (np.array([0, 2, -1], np.int64), np.int64(3),
                              np.array([0.0, 1.0], np.float32)), 1, 0),
    "OneHot_axis": ("OneHot", dict(axis=0), (np.array([1, 0], np.int64),
                                             np.int64(2),
                                             np.array([5.0, 7.0], np.float32)),
                    1, 0),
    "GridSample": ("GridSample", dict(mode=b"bilinear"),
                   (_f(2, 3, 6, 7), GRID), 1, 1e-5),
    "GridSample_3d": ("GridSample", dict(mode=b"linear",
                                         padding_mode=b"border"),
                      (_f(2, 2, 4, 5, 6), GRID3), 1, 1e-5),
    "RoiAlign": ("RoiAlign", dict(output_height=2, output_width=3,
                                  sampling_ratio=2),
                 (_f(1, 2, 8, 10), ROIS, _i(0, 0, 0)), 1, 1e-5),
    "RoiAlign_max": ("RoiAlign", dict(output_height=2, output_width=3,
                                      mode=b"max", sampling_ratio=1),
                              (_f(1, 2, 8, 10), ROIS, _i(0, 0, 0)), 1, 1e-5),
    "LSTM": ("LSTM", dict(hidden_size=5, direction=b"bidirectional"),
             (SEQ, LSTM_W, LSTM_R, _f(2, 8 * 5)), 3, 1e-5),
    "GRU": ("GRU", dict(hidden_size=5, direction=b"bidirectional",
                        linear_before_reset=1),
            (SEQ, GRU_W, GRU_R, _f(2, 6 * 5)), 2, 1e-5),
    "GRU_reset_first": ("GRU", dict(hidden_size=5, clip=0.7),
                        (SEQ, GRU_W[:1], GRU_R[:1], _f(1, 6 * 5)), 2, 1e-5),
    "RNN": ("RNN", dict(hidden_size=4, direction=b"reverse"),
            (SEQ, _f(1, 4, 3), _f(1, 4, 4), _f(1, 8)), 2, 1e-5),
    "SequenceEmpty": ("SequenceEmpty", {}, (), 1, 0),
    "SequenceConstruct": ("SequenceConstruct", {}, (A[0], A[1]), 1, 0),
    "SequenceInsert": ("SequenceInsert", {}, ([A[0], A[1]], A[2],
                                              np.int64(1)), 1, 0),
    "SequenceErase": ("SequenceErase", {}, ([A[0], A[1], A[2]],
                                            np.int64(0)), 1, 0),
    "SequenceAt": ("SequenceAt", {}, ([A[0], A[1]], np.int64(-1)), 1, 0),
    "SequenceLength": ("SequenceLength", {}, ([A[0], A[1]],), 1, 0),
    "ConcatFromSequence": ("ConcatFromSequence", dict(axis=1, new_axis=1),
                           ([A[0], A[1]],), 1, 0),
    "GatherElements": ("GatherElements", dict(axis=0), (A[0, :3, :4], IDX2),
                       1, 0),
    "GatherND": ("GatherND", {}, (A[0], _i(0, 1, 2, 3).reshape(2, 2)), 1, 0),
    "GatherND_batch": ("GatherND", dict(batch_dims=1),
                       (A, np.array([[[2]], [[0]], [[1]]], np.int64)), 1, 0),
    "ScatterElements": ("ScatterElements", dict(axis=1, reduction=b"add"),
                        (A[0], np.array([[0, 4, 4], [2, 2, 0]], np.int64),
                         _f(2, 3)), 1, 1e-6),
    "ScatterND": ("ScatterND", dict(reduction=b"max"),
                  (A[0], np.array([[1], [2], [1]], np.int64), _f(3, 5)), 1,
                  0),
    "LogSoftmax": ("LogSoftmax", dict(axis=1), (A,), 1, 1e-5),
    "CumSum": ("CumSum", dict(exclusive=1, reverse=1), (A, np.int64(1)), 1,
               1e-5),
    "ReduceL1": ("ReduceL1", dict(keepdims=0), (A, _i(1)), 1, 1e-5),
    "ReduceL2": ("ReduceL2", {}, (A, _i(0, 2)), 1, 1e-5),
    "ReduceLogSumExp": ("ReduceLogSumExp", dict(keepdims=0), (A * 300,
                                                             _i(2)), 1, 1e-3),
    "LpNormalization": ("LpNormalization", dict(axis=1, p=1), (A,), 1, 1e-6),
    "Mod": ("Mod", {}, (A, np.float32(0.7)), 1, 1e-6),
    "Mod_fmod": ("Mod", dict(fmod=1), (A, np.float32(0.7)), 1, 1e-6),
    "Mod_int": ("Mod", {}, (_i(7, -7, 7, -7), _i(3, 3, -3, -3)), 1, 0),
    "Sign": ("Sign", {}, (SPECIALS[[0, 4, 5]],), 1, 0),
    "Round": ("Round", {}, (np.array([0.5, 1.5, 2.5, -0.5, -1.7],
                                     np.float32),), 1, 0),
    "Softsign": ("Softsign", {}, (A,), 1, 1e-7),
    "Mish": ("Mish", {}, (A * 5,), 1, 1e-5),
    "Gelu": ("Gelu", {}, (A,), 1, 1e-5),
    "Gelu_tanh": ("Gelu", dict(approximate=b"tanh"), (A,), 1, 1e-5),
    "Celu": ("Celu", dict(alpha=0.7), (A,), 1, 1e-6),
    "ThresholdedRelu": ("ThresholdedRelu", dict(alpha=0.5), (A,), 1, 0),
}

_SEQ_OPS = {"SequenceEmpty", "SequenceConstruct", "SequenceInsert",
            "SequenceErase", "SequenceAt", "SequenceLength",
            "ConcatFromSequence"}


def _seq_same(got, want, atol):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, atol)
    else:
        _assert_same(got, want, atol)


@pytest.mark.parametrize("name", sorted(REST_CASES))
def test_rest_op_matches_jax(name):
    op, attrs, args, n_out, atol = REST_CASES[name]
    got, want = _both_ops(op, attrs, args, n_out)
    _seq_same(got, want, atol)


_TENSOR_CASES = sorted(n for n, c in REST_CASES.items()
                       if c[0] not in _SEQ_OPS | {"NonMaxSuppression"})


@pytest.mark.parametrize("name", _TENSOR_CASES)
def test_rest_op_on_tensors_matches_jax(name):
    """The same cases with their data as tensors, the form a graph run
    hands the ops (inputs that must stay concrete stay NumPy)."""
    op, attrs, args, n_out, atol = REST_CASES[name]
    keep = SHAPE_INPUTS.get(op, ())
    targs = [torch.from_numpy(np.array(a)) if i not in keep
             and isinstance(a, np.ndarray) else a
             for i, a in enumerate(args)]
    jn, pn = _nodes(op, attrs, n_out)
    got = px._OPS[op](pn, *targs)
    assert all(isinstance(g, torch.Tensor) for g in _as_list(got))
    _assert_same(got, jx._OPS[op](jn, *args), atol)


def test_sequence_ops_hold_tensors():
    """Sequences are Python lists of whatever they hold; a tensor
    ConcatFromSequence stacks on the tensors' device."""
    a = torch.ones(2)
    _, pn = _nodes("SequenceConstruct")
    seq = px._OPS["SequenceConstruct"](pn, a, np.zeros(2, np.float32))
    _, pn = _nodes("ConcatFromSequence", dict(axis=0, new_axis=1))
    out = px._OPS["ConcatFromSequence"](pn, seq)
    assert isinstance(out, torch.Tensor) and out.shape == (2, 2)


def test_nonmax_suppression_oracle_and_vmap():
    """The JAX oracle's cases (suppression, score threshold, center boxes,
    max_output 0 or omitted); batched under vmap it raises, as JAX's
    under jit (a data-dependent output shape)."""
    boxes = np.array([[[0, 0, 1, 1], [0, 0.05, 1, 1.05], [0, 2, 1, 3]]],
                     np.float32)
    scores = np.array([[[0.9, 0.8, 0.7]]], np.float32)
    cases = [({}, (boxes, scores, np.int64(10), np.float32(0.5),
                   np.float32(0.75)), [[0, 0, 0]]),
             (dict(center_point_box=1),
              (np.array([[[0.5, 0.5, 1, 1], [3.0, 3.0, 1, 1]]], np.float32),
               np.array([[[0.6, 0.9]]], np.float32), np.int64(10),
               np.float32(0.5)), [[0, 0, 1], [0, 0, 0]]),
             ({}, (boxes, scores), np.zeros((0, 3))),
             ({}, (boxes, scores, np.int64(0)), np.zeros((0, 3)))]
    for attrs, args, want in cases:
        got, jwant = _both_ops("NonMaxSuppression", attrs, args)
        np.testing.assert_array_equal(got, jwant)
        np.testing.assert_array_equal(got, want)
    # a tensor outside vmap is read on the host
    _, pn = _nodes("NonMaxSuppression")
    got = px._OPS["NonMaxSuppression"](pn, torch.from_numpy(boxes),
                                       torch.from_numpy(scores),
                                       np.int64(10), np.float32(0.5))
    np.testing.assert_array_equal(got, [[0, 0, 0], [0, 0, 2]])
    with pytest.raises(ValueError, match="NonMaxSuppression under vmap"):
        torch.func.vmap(lambda b: px._OPS["NonMaxSuppression"](
            pn, b[None], torch.from_numpy(scores)))(torch.from_numpy(boxes))


def test_topk_ties_keep_the_lower_index_on_tensors():
    x = torch.tensor([[3.0, 1.0, 3.0, 2.0, 3.0]])
    for largest, want in ((1, [0, 2, 4]), (0, [1, 3, 0])):
        _, pn = _nodes("TopK", dict(axis=1, largest=largest), 2)
        _, idx = px._OPS["TopK"](pn, x, np.int64(3))
        assert idx.tolist() == [want]
        jn, _ = _nodes("TopK", dict(axis=1, largest=largest), 2)
        _, jidx = jax.jit(lambda a, jn=jn: jx._OPS["TopK"](
            jn, a, np.int64(3)))(x.numpy())
        np.testing.assert_array_equal(np.asarray(jidx), [want])


def test_activation_oracles_match_torch():
    """The JAX test's oracles: the dedicated activation ops against
    torch.nn.functional, and Mod (fmod=0 the floor modulus of
    torch.remainder, fmod=1 torch.fmod), on tensors."""
    x = torch.from_numpy(np.random.default_rng(24).normal(size=(3, 4))
                         .astype(np.float32))
    F = torch.nn.functional
    for op, attrs, fn in (
            ("Mish", {}, F.mish), ("Softsign", {}, F.softsign),
            ("Celu", {"alpha": 0.7}, lambda t: F.celu(t, alpha=0.7)),
            ("ThresholdedRelu", {"alpha": 0.5},
             lambda t: F.threshold(t, 0.5, 0.0)),
            ("Gelu", {"approximate": b"tanh"},
             lambda t: F.gelu(t, approximate="tanh")),
            ("Mod", {}, lambda t: torch.remainder(t, 3.0)),
            ("Mod", {"fmod": 1}, lambda t: torch.fmod(t, 3.0))):
        _, pn = _nodes(op, attrs)
        args = (x, torch.tensor(3.0)) if op == "Mod" else (x,)
        torch.testing.assert_close(px._OPS[op](pn, *args), fn(x),
                                   atol=1e-5, rtol=1e-5, msg=op)


def test_gather_scatter_oracles():
    """The JAX test's gather/scatter oracles (torch.gather, scatter,
    scatter_reduce with duplicate indices) through the port on tensors,
    and against the JAX ops."""
    rng = np.random.default_rng(41)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    idx = np.array([[0, 1, 1, 0], [2, 2, 0, 2]], np.int64)  # duplicates
    upd = rng.normal(size=(2, 4)).astype(np.float32)
    tx, tupd = torch.from_numpy(x), torch.from_numpy(upd)
    for red, tred in (("add", "sum"), ("mul", "prod"), ("min", "amin"),
                      ("max", "amax")):
        jn, pn = _nodes("ScatterElements", dict(axis=0,
                                                reduction=red.encode()))
        want = tx.scatter_reduce(0, torch.from_numpy(idx), tupd, tred,
                                 include_self=True)
        got = px._OPS["ScatterElements"](pn, tx, idx, tupd)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        _assert_same(got, jx._OPS["ScatterElements"](jn, x, idx, upd), 1e-6)
    rows = np.array([[1], [2], [1]], np.int64)
    upd3 = rng.normal(size=(3, 4)).astype(np.float32)
    for red, ufunc in ((b"add", np.add), (b"mul", np.multiply),
                       (b"max", np.maximum), (b"min", np.minimum)):
        want = x.copy()
        ufunc.at(want, (rows[:, 0],), upd3)
        jn, pn = _nodes("ScatterND", dict(reduction=red))
        got = px._OPS["ScatterND"](pn, tx, rows, torch.from_numpy(upd3))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(px._OPS["ScatterND"](
            pn, x, rows, upd3)), want, rtol=1e-6)
    _, pn = _nodes("ScatterND")
    got = px._OPS["ScatterND"](pn, tx, np.array([[1], [-1]], np.int64),
                               torch.zeros(2, 4))
    want = x.copy()
    want[[1, 2]] = 0
    np.testing.assert_array_equal(got.numpy(), want)
    for op in ("ScatterND", "ScatterElements"):
        jn, pn = _nodes(op, dict(reduction=b"xor"))
        for mod, node in ((px, pn), (jx, jn)):
            with pytest.raises(ValueError, match="reduction"):
                mod._OPS[op](node, np.zeros((2,), np.float32),
                             np.array([[0]], np.int64),
                             np.ones((1,), np.float32))


def test_reduce_norms_and_cumsum_variants():
    x = np.random.default_rng(29).normal(size=(2, 5)).astype(np.float32)
    for op, attrs, args, atol in (
            ("ReduceL1", dict(keepdims=0), (x, _i(1)), 1e-6),
            ("ReduceL2", dict(keepdims=1), (x, _i(1)), 1e-6),
            ("ReduceLogSumExp", dict(keepdims=0), (x, _i(1)), 1e-6),
            ("ReduceLogSumExp", dict(keepdims=0),
             (np.array([[1000.0, 999.0], [-2000.0, -2000.0]], np.float32),
              _i(1)), 1e-3),
            ("LpNormalization", dict(axis=1, p=2), (x,), 1e-6)):
        jn, pn = _nodes(op, attrs)
        want = jx._OPS[op](jn, *args)
        for arg in (args[0], torch.from_numpy(args[0])):
            got = px._OPS[op](pn, arg, *args[1:])
            _assert_same(got, want, atol)
            assert np.all(np.isfinite(np.asarray(got)))
    c = np.arange(1.0, 5.0, dtype=np.float32)
    for attrs, want in ((dict(exclusive=1), [0, 1, 3, 6]),
                        (dict(reverse=1), [10, 9, 7, 4]),
                        (dict(exclusive=1, reverse=1), [9, 7, 4, 0])):
        for arg in (c, torch.from_numpy(c)):
            got = px._OPS["CumSum"](_nodes("CumSum", attrs)[1], arg,
                                    np.int64(0))
            np.testing.assert_allclose(np.asarray(got), want)


def test_roi_align_reference_kernel_quirks():
    """The JAX tests' analytic RoiAlign pins (a constant image, an x-ramp
    whose bin averages are the bin centers, max of the WEIGHTED corners,
    zero outside the image, thin ROIs clamped to 1px) on the port, on
    NumPy ROIs and on tensor ROIs (the traced form), equal to JAX's."""
    h, w = 8, 10
    ramp = np.tile(np.arange(w, dtype=np.float32), (h, 1))[None, None]
    const = np.full((1, 1, h, w), 3.25, np.float32)
    bi = _i(0)
    legacy = b"output_half_pixel"
    img = np.zeros((1, 1, 2, 2), np.float32)
    img[0, 0] = [[1.0, 2.0], [3.0, 8.0]]
    cases = [
        (dict(output_height=2, output_width=3, sampling_ratio=2,
              coordinate_transformation_mode=legacy), const,
         np.array([[1.0, 1.0, 7.0, 5.0]], np.float32), np.full((2, 3), 3.25)),
        (dict(output_height=2, output_width=3, sampling_ratio=2,
              coordinate_transformation_mode=legacy), ramp,
         np.array([[1.0, 1.0, 7.0, 5.0]], np.float32),
         np.tile([2.0, 4.0, 6.0], (2, 1))),
        (dict(output_height=2, output_width=3, sampling_ratio=2, mode=b"max",
              coordinate_transformation_mode=legacy), ramp,
         np.array([[1.0, 1.0, 7.0, 5.0]], np.float32),
         np.tile([0.75, 1.25, 1.75], (2, 1))),
        (dict(output_height=2, output_width=2, sampling_ratio=2), ramp,
         np.array([[-6.0, -6.0, 4.0, 4.0]], np.float32),
         [[0.0, 0.0], [0.0, 1.125]]),
        (dict(output_height=1, output_width=1, sampling_ratio=1, mode=b"max"),
         img, np.array([[0.5, 0.5, 1.5, 1.5]], np.float32), [[2.0]]),
        (dict(output_height=1, output_width=1, sampling_ratio=1,
              coordinate_transformation_mode=legacy), ramp,
         np.array([[2.0, 2.0, 2.4, 2.4]], np.float32), [[2.5]]),
        (dict(output_height=2, output_width=2, sampling_ratio=0,
              coordinate_transformation_mode=legacy), ramp,
         np.array([[3.0, 1.0, 5.0, 7.0]], np.float32),
         np.tile([3.5, 4.5], (2, 1))),
    ]
    for attrs, x, rois, want in cases:
        got, jwant = _both_ops("RoiAlign", dict(attrs, spatial_scale=1.0),
                               (x, rois, bi))
        _assert_same(got, jwant, 1e-6)
        np.testing.assert_allclose(np.asarray(got)[0, 0], want, rtol=1e-5,
                                   atol=1e-6)
        _, pn = _nodes("RoiAlign", dict(attrs, spatial_scale=1.0))
        traced = px._OPS["RoiAlign"](pn, torch.from_numpy(x),
                                     torch.from_numpy(rois),
                                     torch.from_numpy(bi))
        np.testing.assert_allclose(traced.numpy(), np.asarray(got),
                                   rtol=1e-5, atol=1e-6)


def test_roi_align_adaptive_ratio_concrete_and_traced():
    """sampling_ratio=0: NumPy ROIs group by their resolved grid, tensor
    ROIs take the masked upper-bound grid; both equal JAX's both forms
    and each other, and zero proposals give an empty output."""
    rng = np.random.default_rng(41)
    img = rng.normal(size=(1, 2, 8, 10)).astype(np.float32)
    bi = _i(0, 0, 0)
    for mode in (b"avg", b"max"):
        attrs = dict(output_height=2, output_width=3, sampling_ratio=0,
                     mode=mode, spatial_scale=1.0)
        jn, pn = _nodes("RoiAlign", attrs)
        want = np.asarray(jx._OPS["RoiAlign"](jn, img, ROIS, bi))
        jtraced = np.asarray(jax.jit(lambda x, r, b, jn=jn: jx._OPS[
            "RoiAlign"](jn, x, r, b))(img, ROIS, bi))
        got = px._OPS["RoiAlign"](pn, img, ROIS, bi)
        traced = px._OPS["RoiAlign"](pn, torch.from_numpy(img),
                                     torch.from_numpy(ROIS),
                                     torch.from_numpy(bi))
        for g in (got, traced, jtraced):
            np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5,
                                       atol=1e-6)
    out = px._OPS["RoiAlign"](pn, img, np.zeros((0, 4), np.float32),
                              np.zeros((0,), np.int64))
    assert np.asarray(out).shape == (0, 2, 2, 3)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_matches_jax_and_torch(mode, padding, align):
    """4-D GridSample in every mode x padding x align_corners against the
    JAX op and F.grid_sample (the JAX tests' bars: 1e-5, bicubic 1e-4)."""
    rng = np.random.default_rng(37)
    x = rng.normal(size=(2, 3, 6, 7)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, size=(2, 4, 5, 2)).astype(np.float32)
    atol = 1e-4 if mode == "bicubic" else 1e-5
    attrs = dict(mode=mode.encode(), padding_mode=padding.encode(),
                 align_corners=int(align))
    got, want = _both_ops("GridSample", attrs, (x, grid))
    _assert_same(got, want, atol)
    oracle = torch.nn.functional.grid_sample(
        torch.from_numpy(x), torch.from_numpy(grid), mode=mode,
        padding_mode=padding, align_corners=align)
    np.testing.assert_allclose(np.asarray(got), oracle.numpy(), atol=atol)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_volumetric_matches_jax(mode, padding, align):
    rng = np.random.default_rng(54)
    x = rng.normal(size=(2, 2, 4, 5, 6)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, size=(2, 3, 2, 4, 3)).astype(np.float32)
    got, want = _both_ops("GridSample", dict(
        mode=mode.encode(), padding_mode=padding.encode(),
        align_corners=int(align)), (x, grid))
    _assert_same(got, want, 1e-5)


def test_grid_sample_zeros_padding_ignores_border_inf():
    """Zeros padding gives exact 0 outside, never inf * 0 = nan from the
    clamped border pixel; a volumetric cubic sample raises JAX's error."""
    x = np.zeros((1, 1, 2, 2), np.float32)
    x[0, 0, 0, 0] = np.inf
    grid = np.array([[[[-2.0, -2.0]]]], np.float32)
    for arg in (x, torch.from_numpy(x)):
        got, _ = _both_ops("GridSample", dict(mode=b"bilinear",
                                              padding_mode=b"zeros"),
                           (arg, grid))
        np.testing.assert_array_equal(np.asarray(got).reshape(()), 0.0)
    _, pn = _nodes("GridSample", dict(mode=b"bicubic"))
    with pytest.raises(ValueError, match="cubic"):
        px._OPS["GridSample"](pn, np.zeros((1, 1, 2, 2, 2), np.float32),
                              np.zeros((1, 1, 1, 1, 3), np.float32))


def test_lstm_clip_matches_numpy_oracle():
    """The clip attribute clamps every gate's pre-activation (the JAX
    test's NumPy step loop); a clip that never binds equals none."""
    rng = np.random.default_rng(53)
    s, bsz, inp, hs = 4, 2, 3, 5
    x = rng.normal(size=(s, bsz, inp)).astype(np.float32) * 3
    w = rng.normal(size=(1, 4 * hs, inp)).astype(np.float32)
    r = rng.normal(size=(1, 4 * hs, hs)).astype(np.float32)
    b = rng.normal(size=(1, 8 * hs)).astype(np.float32)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    h = np.zeros((bsz, hs), np.float32)
    c = np.zeros((bsz, hs), np.float32)
    want = []
    for t in range(s):
        g = np.clip(x[t] @ w[0].T + h @ r[0].T + b[0, :4 * hs]
                    + b[0, 4 * hs:], -0.4, 0.4)
        c = sig(g[:, 2 * hs:3 * hs]) * c + sig(g[:, :hs]) * np.tanh(
            g[:, 3 * hs:])
        h = sig(g[:, hs:2 * hs]) * np.tanh(c)
        want.append(h.copy())
    got, jgot = _both_ops("LSTM", dict(hidden_size=hs, clip=0.4),
                          (x, w, r, b), 3)
    _assert_same(got, jgot, 1e-5)
    np.testing.assert_allclose(got[0].numpy()[:, 0], np.stack(want),
                               atol=1e-5)
    loose, _ = _both_ops("LSTM", dict(hidden_size=hs, clip=1e9),
                         (x, w, r, b), 3)
    plain, _ = _both_ops("LSTM", dict(hidden_size=hs), (x, w, r, b), 3)
    np.testing.assert_allclose(loose[0].numpy(), plain[0].numpy(),
                               atol=1e-6)


@pytest.fixture(scope="module")
def recurrent_export(tmp_path_factory):
    torch.manual_seed(11)
    mod = jtests._Recurrent(bidirectional=True).eval()
    x = np.random.default_rng(33).normal(size=(6, 3, 5)).astype(np.float32)
    path = tmp_path_factory.mktemp("rec") / "rec.onnx"
    export_onnx(mod, path, torch.from_numpy(x), opset=13)
    return mod, x, str(path)


def test_rnn_family_sequence_lens(recurrent_export):
    """sequence_lens: Y is zero past each row's length, the final state
    is the one AT the length, reverse directions run only the valid
    prefix. torch's pack_padded_sequence is the oracle (the JAX test's),
    with the exporter's own weights; tensor lengths equal NumPy ones and
    JAX's traced form."""
    mod, x, path = recurrent_export
    graph = pr.read_onnx_graph(path)
    s = x.shape[0]
    lens = np.array([6, 3, 1], np.int32)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x), torch.from_numpy(lens).long(),
        enforce_sorted=False)

    def weights(op):
        node = next(n for n in graph.nodes if n.op_type == op)
        init = graph.initializers
        return (node, init[node.inputs[1]], init[node.inputs[2]],
                init[node.inputs[3]])

    for op, layer, hidden in (("LSTM", mod.lstm, 7), ("GRU", mod.gru, 6),
                              ("RNN", mod.rnn, 4)):
        node, w, r, b = weights(op)
        got = px._OPS[op](node, torch.from_numpy(x), w, r, b,
                          torch.from_numpy(lens))
        jnode = jr.OnnxNode(node.op_type, node.name, node.inputs,
                            node.outputs, dict(node.attrs))
        want = jax.jit(lambda xx, ll, jnode=jnode, w=w, r=r, b=b: jx._OPS[
            jnode.op_type](jnode, xx, w, r, b, ll))(x, lens)
        _assert_same(got, want, 1e-5)
        _assert_same(px._OPS[op](node, x, w, r, b, lens), want, 1e-5)
        t_out, t_h = layer(packed)
        if op == "LSTM":
            t_h, t_c = t_h
            np.testing.assert_allclose(got[2].numpy(), t_c.detach().numpy(),
                                       atol=1e-5)
        t_out, _ = torch.nn.utils.rnn.pad_packed_sequence(t_out,
                                                          total_length=s)
        t_out = t_out.detach().numpy()
        np.testing.assert_allclose(got[0][:, 0].numpy(),
                                   t_out[..., :hidden], atol=1e-5)
        np.testing.assert_allclose(got[0][:, 1].numpy(),
                                   t_out[..., hidden:], atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), t_h.detach().numpy(),
                                   atol=1e-5)


# -- exports through both executors -------------------------------------


def _both_executors(path, inputs, atol):
    pg, jg = pr.read_onnx_graph(str(path)), jr.read_onnx_graph(str(path))
    got = px.GraphExecutor(pg)(*inputs)
    want = jax.jit(jx.GraphExecutor(jg))(*inputs)
    _assert_same(got, want, atol, rtol=1e-5)
    return pg, got


class _ScatterAdd(torch.nn.Module):
    def forward(self, x, idx, upd):
        return x.scatter_add(1, idx, upd)


def _scatter_inputs():
    return [np.random.default_rng(43).normal(size=(2, 5)).astype(np.float32),
            np.array([[0, 4, 4, 1, 0], [2, 2, 2, 3, 0]], np.int64),
            np.random.default_rng(44).normal(size=(2, 5)).astype(np.float32)]


EXPORTS = {
    # name: (module factory, inputs, opset, atol, ops it must hold)
    "norms_activations": (jtests._NormNet, [X4], 18, 1e-4,
                          {"InstanceNormalization", "Sign", "Round"}),
    "einsum_logsoftmax_cumsum": (jtests._EinsumNet, [A, _f(3, 5, 2)], 13,
                                 1e-5, {"Einsum", "LogSoftmax", "CumSum"}),
    "recurrent": (lambda: jtests._Recurrent(False), [SEQ5 * 1.5], 13, 1e-5,
                  {"LSTM", "GRU", "RNN"}),
    "recurrent_bidirectional": (lambda: jtests._Recurrent(True), [SEQ5], 13,
                                1e-5, {"LSTM", "GRU", "RNN"}),
    "trilu": (jtests._TriluNet, [_f(3, 4, 4)], 14, 1e-5, {"Trilu"}),
    "shrink": (jtests._ShrinkNet, [_f(3, 5)], 11, 1e-5, set()),
    "grid_sample": (jtests._Warp, [_f(1, 3, 16, 16),
                                   _f(1, 12, 12, 2, lo=-1, hi=1)], 16, 1e-5,
                    {"GridSample"}),
    "scatter_add": (_ScatterAdd, _scatter_inputs(), 16, 1e-5,
                    {"ScatterElements"}),
    "transformer_block": (jtests._EncoderBlock, [_f(2, 5, 16)], 17, 1e-5,
                          {"LayerNormalization", "Softmax", "MatMul"}),
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_export_matches_jax(name, tmp_path):
    factory, inputs, opset, atol, ops = EXPORTS[name]
    torch.manual_seed(7)
    mod = factory().eval()
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


# -- the committed exports: CRNN, norms/activations, einsum ---------------

CRNN_INPUT = (2, 1, 32, 24)
OP_FIXTURES = {
    # file: (module factory, seed, input shapes, opset)
    "crnn_opset13.onnx": (lambda: zoo.CRNN(), 1, [CRNN_INPUT], 13),
    "norms_activations_opset18.onnx": (jtests._NormNet, 7,
                                       [(2, 6, 5, 4)], 18),
    "einsum_logsoftmax_cumsum_opset13.onnx": (jtests._EinsumNet, 0,
                                              [(2, 3, 4), (2, 4, 5)], 13),
}


def write_op_fixtures(directory=FIXTURES) -> None:
    """The three op-family exports the card runs without JAX: the CRNN of
    ``tests/model_zoo_torch.py`` (conv columns into a 2-layer
    bidirectional LSTM), and ``tests/test_onnx_exec_ops.py``'s ``_NormNet``
    and ``_EinsumNet``, each seeded, exported with
    ``tests/onnx_export_util.py``."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    for name, (factory, seed, shapes, opset) in OP_FIXTURES.items():
        torch.manual_seed(seed)
        mod = factory().eval()
        export_onnx(mod, pathlib.Path(directory) / name,
                    *[torch.zeros(s) for s in shapes], opset=opset)


def test_committed_op_fixtures_are_the_seeded_exports(tmp_path):
    write_op_fixtures(tmp_path)
    for name in OP_FIXTURES:
        _same_graph(pr.read_onnx_graph(str(tmp_path / name)),
                    pr.read_onnx_graph(str(FIXTURES / name)))


def test_crnn_full_model():
    """The recurrent-family export at model scale (the JAX package's
    test_crnn_full_model): conv columns into a 2-layer bidirectional LSTM,
    against the torch forward and JAX's executor at atol/rtol 1e-4."""
    torch.manual_seed(1)
    mod = zoo.CRNN().eval()
    x = np.random.default_rng(2).normal(size=CRNN_INPUT).astype(
        np.float32) * 0.5
    with torch.no_grad():
        want = mod(torch.from_numpy(x)).numpy()
    path = FIXTURES / "crnn_opset13.onnx"
    graph = pr.read_onnx_graph(str(path))
    assert "LSTM" in {n.op_type for n in graph.nodes}
    got = px.GraphExecutor(graph)(x)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    jgot = jax.jit(jx.GraphExecutor(jr.read_onnx_graph(str(path))))(x)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["norms_activations_opset18.onnx",
                                  "einsum_logsoftmax_cumsum_opset13.onnx"])
def test_committed_op_exports_match_jax(name):
    _, _, shapes, _ = OP_FIXTURES[name]
    rng = np.random.default_rng(len(name))
    inputs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    _both_executors(FIXTURES / name, inputs, 1e-4)


if __name__ == "__main__":
    write_op_fixtures()
