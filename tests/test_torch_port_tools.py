"""The port's operator tools against the JAX package's: ``onnx_run`` (the
counterpart of ``tools/onnx_run.py``), ``loadgen`` (of
``tools/loadgen.py``) and ``models.onnx_exec.load_graph_executor``.

- ``onnx_run`` makes the same random inputs as the JAX tool's
  ``_random_input`` (loaded by path from ``tools/``) and its outputs on
  the committed twin and CRNN exports are within 1e-4 of the JAX
  ``GraphExecutor`` on those inputs (the ``graph_ops`` tolerance);
- ``loadgen`` drives a port server on the CPU (ports bound to 0) and
  prints one JSON line with the JAX tool's keys and frames delivered;
- ``load_graph_executor`` equals ``GraphExecutor(read_onnx_graph(path))``
  exactly, and JAX's loader within 1e-4.
"""

import asyncio
import importlib.util
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from infercam_onnx_tpu.models import onnx_exec as jexec
from infercam_onnx_tpu.models.onnx_reader import read_onnx_graph as jread
from infercam_onnx_tpu_torch import onnx_run
from infercam_onnx_tpu_torch.config import (DetectorConfig, EngineConfig,
                                            ServerConfig)
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.models.onnx_exec import (GraphExecutor,
                                                      load_graph_executor)
from infercam_onnx_tpu_torch.models.onnx_reader import read_onnx_graph
from infercam_onnx_tpu_torch.serving.app import start_server

from tests.test_goldens_fixtures import FIXTURES, REPO, WEIGHTS
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

EXPORTS = {"twin": FIXTURES / "ultraface_twin_rfb320.onnx",
           "crnn": FIXTURES / "crnn_opset13.onnx"}
TOL = 1e-4  # chip_smoke.py graph_ops: the graph runtime card vs CPU


@pytest.fixture(scope="module")
def jax_tool():
    """``tools/onnx_run.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_onnx_run_tool", REPO / "tools" / "onnx_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("export", sorted(EXPORTS))
def test_random_inputs_equal_the_jax_tools(export, seed, jax_tool):
    graph = read_onnx_graph(str(EXPORTS[export]))
    jgraph = jread(str(EXPORTS[export]))
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for info, jinfo in zip(graph.inputs, jgraph.inputs):
        got = onnx_run._random_input(info, rng)
        want = jax_tool._random_input(jinfo, jrng)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("elem_type,dtype,lo,hi", [
    (2, np.uint8, 0, 255), (6, np.int32, 0, 3), (7, np.int64, 0, 3),
    (1, np.float32, None, None)])
def test_random_input_rules_equal_the_jax_tools(elem_type, dtype, lo, hi,
                                                jax_tool):
    class Info:
        shape = (None, 3, 5)

    Info.elem_type = elem_type
    got = onnx_run._random_input(Info, np.random.default_rng(1))
    want = jax_tool._random_input(Info, np.random.default_rng(1))
    assert got.shape == (1, 3, 5) and got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if lo is not None:
        assert lo <= got.min() and got.max() <= hi


def _jax_outputs(path, inputs) -> list[np.ndarray]:
    ex = jexec.GraphExecutor(jread(str(path)))
    return [np.asarray(o) for o in jax.jit(ex)(*inputs)]


@pytest.mark.parametrize("export", sorted(EXPORTS))
def test_onnx_run_matches_jax(export, tmp_path, capsys, jax_tool):
    path = EXPORTS[export]
    out = tmp_path / "out.npz"
    assert onnx_run.main([str(path), "--device", "cpu", "--seed", "2",
                          "--runs", "2", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    jgraph = jread(str(path))
    rng = np.random.default_rng(2)
    inputs = [jax_tool._random_input(i, rng) for i in jgraph.inputs]
    want = _jax_outputs(path, inputs)
    with np.load(out) as got:
        assert got.files == [f"out{i}" for i in range(len(want))]
        for i, w in enumerate(want):
            assert got[f"out{i}"].shape == w.shape
            assert got[f"out{i}"].dtype == w.dtype
            np.testing.assert_allclose(got[f"out{i}"], w, rtol=0, atol=TOL)
    # the JAX tool's summary lines, up to the mean
    assert lines[0].startswith(
        f"{path.name}: {len(jgraph.nodes)} nodes, "
        f"{len(jgraph.initializers)} initializers; device cpu")
    ins = [f"  in  {i.name}: {a.shape} {a.dtype}"
           for i, a in zip(jgraph.inputs, inputs)]
    outs = [f"  out {o.name}: {w.shape} {w.dtype} (mean "
            for o, w in zip(jgraph.outputs, want)]
    assert lines[1:1 + len(ins)] == ins
    assert [ln[:len(p)] for ln, p in zip(lines[1 + len(ins):], outs)] == outs
    assert lines[-1].startswith("2 runs: ") and lines[-1].endswith(" ms/run")


def test_onnx_run_reads_npy_inputs(tmp_path, capsys):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, 32, 24)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    out = tmp_path / "out.npz"
    assert onnx_run.main([str(EXPORTS["crnn"]), "--device", "cpu", "--input",
                          str(tmp_path / "x.npy"), "--out", str(out)]) == 0
    capsys.readouterr()
    want = _jax_outputs(EXPORTS["crnn"], [x])
    with np.load(out) as got:
        np.testing.assert_allclose(got["out0"], want[0], rtol=0, atol=TOL)
    with pytest.raises(SystemExit) as err:  # one array for a 1-input graph
        onnx_run.main([str(EXPORTS["crnn"]), "--device", "cpu", "--input",
                       str(tmp_path / "x.npy"), str(tmp_path / "x.npy")])
    assert err.value.code == 2


def test_onnx_run_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: onnx_run runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        onnx_run.main([str(EXPORTS["crnn"])])


@pytest.mark.parametrize("export", sorted(EXPORTS))
def test_load_graph_executor(export):
    path = str(EXPORTS[export])
    rng = np.random.default_rng(5)
    inputs = [onnx_run._random_input(i, rng)
              for i in read_onnx_graph(path).inputs]
    ex = load_graph_executor(path)
    assert isinstance(ex, GraphExecutor)
    with torch.inference_mode():
        got = [o.numpy() for o in ex(*map(torch.from_numpy, inputs))]
        plain = [o.numpy() for o in GraphExecutor(read_onnx_graph(path))(
            *map(torch.from_numpy, inputs))]
    want = [np.asarray(o) for o in jax.jit(jexec.load_graph_executor(path))(
        *inputs)]
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


async def _loadgen(cmd: list[str]) -> dict:
    proc = await asyncio.create_subprocess_exec(
        *cmd, cwd=str(REPO), stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(), 120)
    assert proc.returncode == 0, err.decode()[-2000:]
    lines = out.decode().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_loadgen_drives_a_port_server():
    """Two streams at 10 fps for 2 s against a port server on the CPU; the
    same traffic from the JAX tool prints the same keys."""
    detector = Detector(DetectorConfig(compute_dtype="float32"),
                        weights=str(WEIGHTS), device="cpu")

    async def run():
        server = await start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0"),
            engine_config=EngineConfig(batch_buckets=(1, 2),
                                       annotate_mode="host",
                                       link_adaptive=False),
            detector=detector)
        try:
            flags = ["--server", f"127.0.0.1:{server.http_port}",
                     "--socket", f"127.0.0.1:{server.socket_port}",
                     "--streams", "2", "--fps", "10", "--seconds", "2",
                     "--warmup-seconds", "1"]
            port = await _loadgen([sys.executable, "-m",
                                   "infercam_onnx_tpu_torch.loadgen",
                                   *flags])
            jax_tool = await _loadgen([sys.executable,
                                       str(REPO / "tools" / "loadgen.py"),
                                       *flags, "--channel-prefix", "jax"])
        finally:
            await server.close()
        return port, jax_tool

    got, want = asyncio.run(run())
    assert set(got) == set(want) | {"sender_errors"}
    assert got["sender_errors"] == 0
    assert got["streams"] == 2 and got["input_fps"] == 20.0
    assert got["server_inferred_fps"] > 0 and got["server_batches_per_s"] > 0
    assert got["client_received_per_s"] > 0  # /detections records arrived
    assert want["server_inferred_fps"] > 0
