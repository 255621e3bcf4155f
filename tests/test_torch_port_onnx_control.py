"""The port's If/Loop/Scan against the JAX executor's
(``models/onnx_exec.py:2075-2423`` there): the build-time checks with
JAX's messages, the oracles of ``tests/test_onnx_exec_ops.py`` (concrete
and data-dependent conditions, torchscript loops and sequences, scan
outputs, nested control flow), and the batched forms: under
`torch.func.vmap` a data-dependent If selects per image and a
data-dependent Loop runs until every image's condition fails, equal to
``jax.vmap`` of the JAX executor. Bodies are child modules: their
constants are buffers, so no iteration copies one from the host.
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

from onnx_export_util import export_onnx  # noqa: E402
from test_torch_port_onnx import _assert_same  # noqa: E402


def _both(build):
    """``build(module)`` -> OnnxGraph, for JAX's reader classes and the
    port's: (JAX executor, port executor)."""
    return jx.GraphExecutor(build(jr)), px.GraphExecutor(build(pr))


def _const_branch(m, value, name="y"):
    return m.OnnxGraph(
        nodes=[m.OnnxNode("Constant", f"c{value}", [], [name],
                          {"value": np.asarray(value, np.float32)})],
        initializers={}, inputs=[],
        outputs=[m.OnnxValueInfo(name, 1, list(np.shape(value)))])


def _if_graph(m, then_value=1.0, else_value=2.0):
    return m.OnnxGraph(
        nodes=[m.OnnxNode("If", "pick", ["cond"], ["out"],
                          {"then_branch": _const_branch(m, then_value),
                           "else_branch": _const_branch(m, else_value)})],
        initializers={}, inputs=[m.OnnxValueInfo("cond", 9, [])],
        outputs=[m.OnnxValueInfo("out", 1, [])])


def test_if_concrete_traced_and_mismatched_conditions():
    """A readable condition runs one branch (the JAX executor's concrete
    path, no same-shape constraint); a condition batched under vmap runs
    both and selects per image, equal to jax.vmap (lax.cond); batched with
    mismatched branch shapes it raises JAX's error, as jax.jit does; a
    branch output never produced fails at build with JAX's message."""
    jex, pex = _both(_if_graph)
    for cond in (True, False):
        assert float(pex(np.asarray(cond))[0]) == \
            float(jex(np.asarray(cond))[0])
    conds = np.array([True, False, True])
    got = torch.func.vmap(pex)(torch.from_numpy(conds))[0]
    want = jax.vmap(jex)(conds)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1.0, 2.0, 1.0]

    jmix, pmix = _both(lambda m: _if_graph(m, 1.0, np.zeros(3, np.float32)))
    assert tuple(pmix(np.asarray(False))[0].shape) == (3,) == \
        np.asarray(jmix(np.asarray(False))[0]).shape
    with pytest.raises(ValueError, match="matching shapes"):
        torch.func.vmap(pmix)(torch.tensor([True, False]))
    with pytest.raises(ValueError, match="matching shapes"):
        jax.jit(jmix)(np.asarray(True))

    def bad(m):
        g = _if_graph(m)
        g.nodes[0].attrs["then_branch"].outputs[0].name = "nonexistent"
        return g

    with pytest.raises(ValueError) as perr:
        px.GraphExecutor(bad(pr))
    with pytest.raises(ValueError) as jerr:
        jx.GraphExecutor(bad(jr))
    assert "never produced" in str(perr.value)
    assert str(perr.value) == str(jerr.value)


def _data_if_graph(m):
    """out = x * 2 if sum(x) > 0 else x - 1: a condition from data."""
    return m.OnnxGraph(
        nodes=[m.OnnxNode("ReduceSum", "s", ["x"], ["sum"], {"keepdims": 0}),
               m.OnnxNode("Greater", "g", ["sum", "zero"], ["pos"], {}),
               m.OnnxNode("If", "pick", ["pos"], ["out"], {
                   "then_branch": m.OnnxGraph(
                       nodes=[m.OnnxNode("Mul", "dbl", ["x", "two"], ["y"],
                                         {})],
                       initializers={"two": np.float32(2.0)}, inputs=[],
                       outputs=[m.OnnxValueInfo("y", 1, [3])]),
                   "else_branch": m.OnnxGraph(
                       nodes=[m.OnnxNode("Sub", "dec", ["x", "one"], ["y"],
                                         {})],
                       initializers={"one": np.float32(1.0)}, inputs=[],
                       outputs=[m.OnnxValueInfo("y", 1, [3])])})],
        initializers={"zero": np.float32(0.0)},
        inputs=[m.OnnxValueInfo("x", 1, [3])],
        outputs=[m.OnnxValueInfo("out", 1, [3])])


def test_traced_if_under_vmap_matches_jax_vmap():
    """A data-dependent If under torch.func.vmap equals jax.vmap of JAX's
    executor per image, and each image's single run; the branches'
    initializers are buffers (no host copy a call, outside vmap or in)."""
    jex, pex = _both(_data_if_graph)
    xs = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
    got = torch.func.vmap(pex)(torch.from_numpy(xs))[0]
    assert pex.host_copies == 0
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.vmap(jex)(xs)[0]))
    for x, row in zip(xs, got):
        assert torch.equal(pex(torch.from_numpy(x))[0], row)
        assert pex.host_copies == 0
    assert {np.sign(x.sum()) for x in xs} == {-1.0, 1.0}


def _doubling_loop(m, trip=None):
    """x doubles while x < limit (the JAX test's data-dependent loop)."""
    body = m.OnnxGraph(
        nodes=[m.OnnxNode("Mul", "dbl", ["x_in", "two"], ["x_out"], {}),
               m.OnnxNode("Less", "chk", ["x_out", "limit"], ["cond_out"],
                          {})],
        initializers={"two": np.float32(2.0)},
        inputs=[m.OnnxValueInfo("iter", 7, []),
                m.OnnxValueInfo("cond_in", 9, []),
                m.OnnxValueInfo("x_in", 1, [])],
        outputs=[m.OnnxValueInfo("cond_out", 9, []),
                 m.OnnxValueInfo("x_out", 1, [])])
    inits = {"limit": np.float32(10.0)}
    if trip is not None:
        inits["m"] = np.int64(trip)
    return m.OnnxGraph(
        nodes=[m.OnnxNode("Less", "c0", ["x", "limit"], ["go"], {}),
               m.OnnxNode("Loop", "L", ["m" if trip is not None else "",
                                        "go", "x"], ["final"],
                          {"body": body})],
        initializers=inits, inputs=[m.OnnxValueInfo("x", 1, [])],
        outputs=[m.OnnxValueInfo("final", 1, [])])


def test_loop_data_dependent_condition():
    """Outside vmap the host reads the condition each step; torchscript's
    `while cond:` trip count (INT64_MAX) is unbounded; a trip count of 2
    stops first. The body initializer is a buffer: no host copy."""
    for trip, cases in ((None, [(3.0, 12.0), (0.5, 16.0), (64.0, 64.0)]),
                        (2 ** 63 - 1, [(3.0, 12.0)]),
                        (2, [(0.5, 2.0), (3.0, 12.0)])):
        jex, pex = _both(lambda m: _doubling_loop(m, trip))
        for x0, want in cases:
            got = pex(np.float32(x0))[0]
            assert float(got) == want == float(jax.jit(jex)(np.float32(x0))[0])
            assert pex.host_copies == 0


def test_data_dependent_loop_under_vmap_matches_jax_vmap():
    """A data-dependent Loop inside torch.func.vmap: each image stops on
    its own condition (the loop runs until all have), equal to jax.vmap
    of JAX's executor (lax.while_loop's batching), with and without a
    trip count."""
    xs = np.array([3.0, 0.5, 64.0, 9.0, 0.01], np.float32)
    for trip in (None, 3):
        jex, pex = _both(lambda m: _doubling_loop(m, trip))
        got = torch.func.vmap(pex)(torch.from_numpy(xs))[0]
        want = jax.vmap(jex)(xs)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert pex.host_copies == 0
    # trip count 3: each image doubles at most three times
    np.testing.assert_allclose(got.numpy(), [12.0, 4.0, 64.0, 18.0, 0.08],
                               rtol=1e-6)


def test_traced_loop_refusals_equal_jax():
    """Under vmap, a batched trip count raises (JAX: under jit); a body
    whose carried shape changes raises the iteration-invariance error."""
    def counted(m):
        body = m.OnnxGraph(
            nodes=[m.OnnxNode("Identity", "c", ["cond_in"], ["cond_out"], {}),
                   m.OnnxNode("Add", "a", ["s_in", "one"], ["s_out"], {})],
            initializers={"one": np.float32(1.0)},
            inputs=[m.OnnxValueInfo("i", 7, []),
                    m.OnnxValueInfo("cond_in", 9, []),
                    m.OnnxValueInfo("s_in", 1, [])],
            outputs=[m.OnnxValueInfo("cond_out", 9, []),
                     m.OnnxValueInfo("s_out", 1, [])])
        return m.OnnxGraph(
            nodes=[m.OnnxNode("Loop", "L", ["n", "", "s"], ["t"],
                              {"body": body})],
            initializers={"s": np.float32(0.0)},
            inputs=[m.OnnxValueInfo("n", 7, [])],
            outputs=[m.OnnxValueInfo("t", 1, [])])

    jex, pex = _both(counted)
    assert float(pex(np.int64(4))[0]) == float(jex(np.int64(4))[0]) == 4.0
    with pytest.raises(ValueError, match="trip count"):
        torch.func.vmap(pex)(torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="trip count"):
        jax.jit(jex)(np.int64(3))

    def growing(m):
        g = _doubling_loop(m)
        g.nodes[1].attrs["body"].nodes[0] = m.OnnxNode(
            "Concat", "dbl", ["x_in", "x_in"], ["x_out"], {"axis": 0})
        g.nodes[1].attrs["body"].nodes[1] = m.OnnxNode(
            "ReduceSum", "s", ["x_out"], ["tot"], {"keepdims": 0})
        g.nodes[1].attrs["body"].nodes.append(m.OnnxNode(
            "Less", "chk", ["tot", "limit"], ["cond_out"], {}))
        return g

    _, pgrow = _both(growing)
    with pytest.raises(ValueError, match="iteration-invariant"):
        torch.func.vmap(pgrow)(torch.tensor([[1.0], [2.0]]))


class _ScriptedLoop(torch.nn.Module):
    def forward(self, x, n: int):
        y = x
        for i in range(n):
            y = y + x * float(i)
        return y


def test_loop_export_from_torchscript(tmp_path):
    """A torch.jit.script Python loop exports as ONNX Loop (outer-scope
    capture, carried values): trip counts 0, 1, 5 against torch and JAX."""
    path = tmp_path / "loop.onnx"
    export_onnx(torch.jit.script(_ScriptedLoop()), path, torch.zeros(2, 3),
                torch.tensor(4))
    graph = pr.read_onnx_graph(str(path))
    assert any(n.op_type == "Loop" for n in graph.nodes)
    pex = px.GraphExecutor(graph)
    jex = jx.GraphExecutor(jr.read_onnx_graph(str(path)))
    x = np.random.default_rng(21).normal(size=(2, 3)).astype(np.float32)
    for n in (0, 1, 5):
        got = pex(x, np.int64(n))[0]
        want = _ScriptedLoop()(torch.from_numpy(x), n).numpy()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        _assert_same(got, jex(x, np.int64(n))[0], 1e-6)


class _SeqLoop(torch.nn.Module):
    def forward(self, x, n: int):
        ys: "list[torch.Tensor]" = []
        y = x
        for i in range(n):
            y = y * 0.9 + 1.0
            ys.append(y)
        return torch.stack(ys)


def test_sequence_ops_through_scripted_loop(tmp_path):
    """A torchscript list-append loop: SequenceEmpty/SequenceInsert carried
    by a Loop and ConcatFromSequence, sequences as Python lists."""
    path = tmp_path / "seq.onnx"
    export_onnx(torch.jit.script(_SeqLoop()), path, torch.zeros(2, 3),
                torch.tensor(4), opset=13)
    graph = pr.read_onnx_graph(str(path))
    assert "ConcatFromSequence" in {n.op_type for n in graph.nodes}
    pex = px.GraphExecutor(graph)
    jex = jx.GraphExecutor(jr.read_onnx_graph(str(path)))
    x = np.random.default_rng(31).normal(size=(2, 3)).astype(np.float32)
    for n in (1, 4):
        got = pex(x, np.int64(n))[0]
        want = _SeqLoop()(torch.from_numpy(x), n).numpy()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        _assert_same(got, jex(x, np.int64(n))[0], 1e-6)


def _loop_scan_graph(m):
    body = m.OnnxGraph(
        nodes=[m.OnnxNode("Identity", "c", ["cond_in"], ["cond_out"], {}),
               m.OnnxNode("Add", "acc", ["carry_in", "step"], ["carry_out"],
                          {}),
               m.OnnxNode("Identity", "s", ["carry_out"], ["scan"], {})],
        initializers={"step": np.float32(2.0)},
        inputs=[m.OnnxValueInfo("iter", 7, []),
                m.OnnxValueInfo("cond_in", 9, []),
                m.OnnxValueInfo("carry_in", 1, [])],
        outputs=[m.OnnxValueInfo("cond_out", 9, []),
                 m.OnnxValueInfo("carry_out", 1, []),
                 m.OnnxValueInfo("scan", 1, [])])
    return m.OnnxGraph(
        nodes=[m.OnnxNode("Loop", "L", ["m", "", "init"], ["final", "trace"],
                          {"body": body})],
        initializers={},
        inputs=[m.OnnxValueInfo("m", 7, []), m.OnnxValueInfo("init", 1, [])],
        outputs=[m.OnnxValueInfo("final", 1, []),
                 m.OnnxValueInfo("trace", 1, [None])])


def test_loop_scan_outputs():
    """Per-iteration scan outputs stack along a new axis 0; zero
    iterations with scan outputs raise JAX's error."""
    jex, pex = _both(_loop_scan_graph)
    final, trace = pex(np.int64(3), np.float32(1.0))
    assert float(final) == 7.0
    np.testing.assert_allclose(trace.numpy(), [3.0, 5.0, 7.0])
    _assert_same(trace, jex(np.int64(3), np.float32(1.0))[1], 0)
    with pytest.raises(ValueError) as perr:
        pex(np.int64(0), np.float32(1.0))
    with pytest.raises(ValueError) as jerr:
        jex(np.int64(0), np.float32(1.0))
    assert str(perr.value) == str(jerr.value)


def _scan_graph(m, **attrs):
    body = m.OnnxGraph(
        nodes=[m.OnnxNode("Add", "acc", ["s_in", "x_t"], ["s_out"], {}),
               m.OnnxNode("Mul", "y", ["s_out", "w"], ["y_t"], {})],
        initializers={"w": np.float32(1.0)},
        inputs=[m.OnnxValueInfo("s_in", 1, []),
                m.OnnxValueInfo("x_t", 1, [])],
        outputs=[m.OnnxValueInfo("s_out", 1, []),
                 m.OnnxValueInfo("y_t", 1, [])])
    return m.OnnxGraph(
        nodes=[m.OnnxNode("Scan", "S", ["init", "xs"], ["final", "ys"],
                          {"body": body, "num_scan_inputs": 1, **attrs})],
        initializers={},
        inputs=[m.OnnxValueInfo("init", 1, []),
                m.OnnxValueInfo("xs", 1, [None])],
        outputs=[m.OnnxValueInfo("final", 1, []),
                 m.OnnxValueInfo("ys", 1, [None])])


def test_scan_cumulative_sum():
    """Scan: a running sum, forwards and reversed, against JAX; under
    torch.func.vmap against jax.vmap; a zero-length scan input with scan
    outputs raises JAX's error."""
    init = np.float32(0.0)
    xs = np.arange(1.0, 5.0, dtype=np.float32)
    for attrs, want in (({}, [1, 3, 6, 10]),
                        (dict(scan_input_directions=[1],
                              scan_output_directions=[1]), [10, 9, 7, 4])):
        jex, pex = _both(lambda m: _scan_graph(m, **attrs))
        final, ys = pex(init, xs)
        assert float(final) == 10.0
        np.testing.assert_allclose(ys.numpy(), want)
        _assert_same([final, ys], list(jex(init, xs)), 0)
        assert pex.host_copies == 0
    batch = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    inits = np.zeros(4, np.float32)
    got = torch.func.vmap(pex)(torch.from_numpy(inits),
                               torch.from_numpy(batch))
    want = jax.vmap(jex)(inits, batch)
    _assert_same(list(got), list(want), 1e-6)
    with pytest.raises(ValueError) as perr:
        pex(init, np.zeros((0,), np.float32))
    with pytest.raises(ValueError) as jerr:
        jex(init, np.zeros((0,), np.float32))
    assert "zero-length" in str(perr.value)
    assert str(perr.value) == str(jerr.value)


def test_nested_control_flow_loop_with_if_body():
    """A Loop whose body holds an If (two levels of subgraphs): add 2 on
    even iterations, 1 on odd; n=4 -> 6, as JAX; the If's branches and
    the body's initializers are buffers of child modules, carried by a
    deep copy."""
    def build(m):
        body = m.OnnxGraph(
            nodes=[
                m.OnnxNode("Mod", "par", ["iter", "two_i"], ["rem"], {}),
                m.OnnxNode("Equal", "iseven", ["rem", "zero_i"], ["even"],
                           {}),
                m.OnnxNode("If", "pick", ["even"], ["delta"], {
                    "then_branch": _const_branch(m, 2.0, "step"),
                    "else_branch": _const_branch(m, 1.0, "step")}),
                m.OnnxNode("Add", "acc", ["s_in", "delta"], ["s_out"], {}),
                m.OnnxNode("Identity", "cc", ["cond_in"], ["cond_out"], {}),
            ],
            initializers={"two_i": np.int64(2), "zero_i": np.int64(0)},
            inputs=[m.OnnxValueInfo("iter", 7, []),
                    m.OnnxValueInfo("cond_in", 9, []),
                    m.OnnxValueInfo("s_in", 1, [])],
            outputs=[m.OnnxValueInfo("cond_out", 9, []),
                     m.OnnxValueInfo("s_out", 1, [])])
        return m.OnnxGraph(
            nodes=[m.OnnxNode("Loop", "L", ["n", "", "s0"], ["total"],
                              {"body": body})],
            initializers={},
            inputs=[m.OnnxValueInfo("n", 7, []),
                    m.OnnxValueInfo("s0", 1, [])],
            outputs=[m.OnnxValueInfo("total", 1, [])])

    jex, pex = _both(build)
    assert float(pex(np.int64(4), np.float32(0.0))[0]) == 6.0 == \
        float(jex(np.int64(4), np.float32(0.0))[0])
    assert pex.host_copies == 0
    names = {n for n, _ in pex.named_buffers()}
    assert any(n.startswith("_bodies.n0_body._bodies.") for n in names)
    clone = copy.deepcopy(pex)
    assert float(clone(np.int64(5), np.float32(1.0))[0]) == 9.0


def _malformed_cases(m):
    def g(nodes, inputs, outputs):
        return m.OnnxGraph(nodes=nodes, initializers={}, inputs=inputs,
                           outputs=outputs)

    def scalar(n):
        return m.OnnxValueInfo(n, 1, [])

    body = g([m.OnnxNode("Identity", "i", ["a"], ["b"], {})],
             [scalar("a")], [scalar("b")])
    return [
        (m.OnnxNode("If", "f", ["c"], ["o"], {}), [scalar("c")]),
        (m.OnnxNode("If", "f", ["c"], ["o", "p"],
                    {"then_branch": body, "else_branch": body}),
         [scalar("c")]),
        (m.OnnxNode("Loop", "l", ["m", "", "s"], ["o"], {}),
         [scalar("m"), scalar("s")]),
        (m.OnnxNode("Loop", "l", ["m", "", "s"], ["o"], {"body": body}),
         [scalar("m"), scalar("s")]),
        (m.OnnxNode("Scan", "s", ["x"], ["o"], {"body": body}),
         [scalar("x")]),
        (m.OnnxNode("Scan", "s", ["st", "x"], ["o1", "o2"],
                    {"body": body, "num_scan_inputs": 1}),
         [scalar("st"), scalar("x")]),
        (m.OnnxNode("Scan", "s", ["x"], ["o1", "o2"],
                    {"body": body, "num_scan_inputs": 1}), [scalar("x")]),
        (m.OnnxNode("Scan", "s", ["x"], ["o"], {"body": g(
            [m.OnnxNode("FooOp", "deep", ["a"], ["b"], {})],
            [scalar("a")], [scalar("b")]), "num_scan_inputs": 1}),
         [scalar("x")]),
    ], g


def test_malformed_control_flow_fails_at_build():
    """Every malformed If/Loop/Scan (missing branches or body, body or
    output arity, num_scan_inputs, an unknown op inside a body) fails when
    the executor is built, with the JAX executor's message."""
    jcases, jg = _malformed_cases(jr)
    pcases, pg = _malformed_cases(pr)
    assert len(jcases) == len(pcases) == 8
    for (jnode, jin), (pnode, pin) in zip(jcases, pcases):
        with pytest.raises(ValueError) as jerr:
            jx.GraphExecutor(jg([jnode], jin, [jr.OnnxValueInfo(o, 1, [])
                                               for o in jnode.outputs]))
        with pytest.raises(ValueError) as perr:
            px.GraphExecutor(pg([pnode], pin, [pr.OnnxValueInfo(o, 1, [])
                                               for o in pnode.outputs]))
        assert str(perr.value) == str(jerr.value)


def test_bodies_follow_the_executor_to_a_device_and_a_copy():
    """A body's constants are buffers of a child module: `.to()` and a
    deep copy carry them (the replica path of `ShardedGraphDetector`), and
    a run of the copy reads its own."""
    _, pex = _both(_data_if_graph)
    body_buffers = [n for n, _ in pex.named_buffers() if "_bodies" in n]
    assert len(body_buffers) == 2
    clone = copy.deepcopy(pex).to(torch.float32)
    x = torch.tensor([0.5, -2.0, 0.25])
    assert torch.equal(clone(x)[0], pex(x)[0])
    for (name, a), (_, b) in zip(pex.named_buffers(), clone.named_buffers()):
        assert a.data_ptr() != b.data_ptr(), name
