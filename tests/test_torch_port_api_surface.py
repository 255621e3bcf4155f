"""The port's public surface against the JAX package's, and the small
helpers that make it whole.

`test_module_surface` walks every module of ``infercam_onnx_tpu`` (one
case each) except ``ops/pallas/*``, whose counterpart is ``ops/nms.py``
with ``csrc/nms.cu``. For each public top-level name, public method (and
``__init__`` / ``__call__``), dataclass field and class attribute, the
module of the same path in ``infercam_onnx_tpu_torch`` must have a
counterpart of the same name; for each public function and method, every
parameter name of JAX's signature must be in the port's. The by-design
differences are in `BY_DESIGN`, each with its reason (ROADMAP.md, "No
counterpart, by design").

The rest holds the helpers against JAX's on the CPU: the sub-package and
top-level exports, ``ParallelConfig``, ``decode_ycbcr_batch(threads=)``,
``warmup(pack_output=)``, ``StageTimer.format_drain``,
``Broadcast.close_all``, ``handle_incoming``, ``HttpServer.serve_forever``
and ``InferServer.ingest_queue``.
"""

import ast
import asyncio
import dataclasses
import importlib
import inspect
import logging
import pathlib
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "infercam_onnx_tpu"
TWIN_ONNX = REPO / "tests" / "fixtures" / "ultraface_twin_rfb320.onnx"

# The port's by-design differences: (JAX module, name) -> None where the
# name has no counterpart, or the set of JAX parameter names the port's
# signature leaves out. Nothing else may be missing.
_DEVICE_PROGRAM = {"params", "compute_dtype"}
BY_DESIGN: dict[tuple[str, str], set | None] = {
    # device programs take the module (``model``, in its dtype) where JAX
    # takes the params pytree and ``compute_dtype``
    **{("infercam_onnx_tpu.detector", name): _DEVICE_PROGRAM for name in (
        "detect_program", "detect_from_ycbcr", "detect_from_coefficients",
        "detect_annotate", "detect_annotate_from_ycbcr",
        "detect_annotate_splice")},
    # ... and JAX's ``flat_sharding`` places outputs on a jax.sharding mesh;
    # the port's tiled programs run on one device, `TiledDetector` splits
    ("infercam_onnx_tpu.parallel.tiling", "tiled_detect_program"):
        _DEVICE_PROGRAM | {"flat_sharding"},
    ("infercam_onnx_tpu.parallel.tiling", "tiled_detect_from_ycbcr_program"):
        _DEVICE_PROGRAM | {"flat_sharding"},
    ("infercam_onnx_tpu.parallel.tiling",
     "tiled_detect_from_ycbcr_rows_program"): {"params"},
    # the ``*_impl`` bodies of JAX's jitted programs: the port's programs
    # are plain functions, so there is nothing to jit around
    **{("infercam_onnx_tpu.detector", f"{name}_impl"): None for name in (
        "detect_program", "detect_from_ycbcr", "detect_from_coefficients",
        "detect_annotate", "detect_annotate_from_ycbcr",
        "detect_annotate_splice")},
    # knobs the port's serving tier made constants: the one METER, the
    # router's stream age and the stage timer's reservoir size
    ("infercam_onnx_tpu.serving.http", "HttpServer.__init__"): {"meter"},
    ("infercam_onnx_tpu.serving.inferer", "InferenceWorker.__init__"):
        {"meter"},
    ("infercam_onnx_tpu.serving.meter", "meter_logger"): {"meter"},
    ("infercam_onnx_tpu.serving.router", "FrameRouter.__init__"): {"meter"},
    ("infercam_onnx_tpu.serving.router", "FrameRouter.active_streams"):
        {"max_age_s"},
    ("infercam_onnx_tpu.utils.profiling", "StageTimer.__init__"):
        {"max_samples_per_stage"},
    # the port's `GraphDetector.to_mesh` returns a ShardedGraphDetector
    ("infercam_onnx_tpu.models.onnx_exec", "GraphDetector.__init__"):
        {"mesh"},
    # a mesh is a list of devices in the port, with no named axis
    ("infercam_onnx_tpu.parallel.mesh", "make_mesh"): {"axis"},
    # XLA's compilation cache; the port caches its builds by source hash
    ("infercam_onnx_tpu.utils.cache", "enable_compilation_cache"): None,
}


def _jax_modules() -> list[tuple[str, pathlib.Path]]:
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[1:3] == ["ops", "pallas"]:
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append((".".join(parts), path))
    return out


MODULES = _jax_modules()


def _public(name: str) -> bool:
    return not name.startswith("_")


def _top_level(tree: ast.Module, is_init: bool) -> dict[str, ast.AST]:
    """Public names a module defines (and, in a package's __init__, the
    names it imports or serves lazily through __getattr__: those map to
    their import node or to None, and their own module checks them)."""
    names: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names[n.id] = node
        elif is_init and isinstance(node, ast.ImportFrom):
            for alias in node.names:
                names[alias.asname or alias.name] = node
    if is_init:
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "__getattr__":
                for n in ast.walk(node):
                    if isinstance(n, ast.Constant) \
                            and isinstance(n.value, str) \
                            and n.value.isidentifier():
                        names.setdefault(n.value, None)
    return {k: v for k, v in names.items() if _public(k)}


def _param_names(fn) -> set[str]:
    return {p for p in inspect.signature(fn).parameters
            if p not in ("self", "cls")}


def _port_attributes(cls) -> set[str]:
    """Everything a port class offers by name: its attributes, dataclass
    fields, and the ``self.<name> = ...`` attributes its own and its
    port-package bases' methods set."""
    names = set(dir(cls))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    for base in cls.__mro__:
        if not base.__module__.startswith("infercam_onnx_tpu_torch"):
            continue
        tree = ast.parse(textwrap.dedent(inspect.getsource(base)))
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store) \
                    and isinstance(n.value, ast.Name) and n.value.id == "self":
                names.add(n.attr)
    return names


def _signature_gap(jax_fn, port_fn, key) -> list[str]:
    allowed = BY_DESIGN.get(key) or set()
    return sorted(_param_names(jax_fn) - _param_names(port_fn) - allowed)


def _class_gaps(mod: str, name: str, node: ast.ClassDef, jcls, tcls):
    gaps = []
    attrs = _port_attributes(tcls)
    is_module = issubclass(tcls, torch.nn.Module)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            meth = item.name
            if not (_public(meth) or meth in ("__init__", "__call__")):
                continue
            key = (mod, f"{name}.{meth}")
            if meth not in attrs:
                gaps.append(f"{name}.{meth}: missing")
                continue
            decorators = {getattr(d, "id", getattr(d, "attr", None))
                          for d in item.decorator_list}
            if "property" in decorators:
                continue
            if meth == "__init__":
                jfn, tfn = jcls, tcls
            else:
                jfn = getattr(jcls, meth)
                # an nn.Module is called through forward
                tfn = (tcls.forward if meth == "__call__" and is_module
                       else getattr(tcls, meth))
            missing = _signature_gap(jfn, tfn, key)
            if missing:
                gaps.append(f"{name}.{meth}: parameters {missing}")
        elif isinstance(item, (ast.Assign, ast.AnnAssign)):
            targets = (item.targets if isinstance(item, ast.Assign)
                       else [item.target])
            for t in targets:
                if isinstance(t, ast.Name) and _public(t.id) \
                        and t.id not in attrs:
                    gaps.append(f"{name}.{t.id}: missing field")
    return gaps


@pytest.mark.parametrize("mod,path", MODULES, ids=[m for m, _ in MODULES])
def test_module_surface(mod, path):
    jmod = importlib.import_module(mod)
    port_name = "infercam_onnx_tpu_torch" + mod[len("infercam_onnx_tpu"):]
    tmod = importlib.import_module(port_name)
    tree = ast.parse(path.read_text())
    gaps = []
    for name, node in _top_level(tree, path.name == "__init__.py").items():
        key = (mod, name)
        if key in BY_DESIGN and BY_DESIGN[key] is None:
            continue
        if not hasattr(tmod, name):
            gaps.append(f"{name}: missing")
            continue
        jobj, tobj = getattr(jmod, name), getattr(tmod, name)
        if node is None or isinstance(node, ast.ImportFrom):
            continue  # a re-export: its own module is checked
        if isinstance(node, ast.ClassDef):
            gaps += _class_gaps(mod, name, node, jobj, tobj)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) or (
                callable(jobj) and not isinstance(jobj, type)
                and (inspect.isroutine(jobj) or hasattr(jobj, "__wrapped__"))):
            missing = _signature_gap(jobj, tobj, key)
            if missing:
                gaps.append(f"{name}: parameters {missing}")
    assert not gaps, f"{port_name} lacks JAX's " + "; ".join(gaps)


def test_by_design_entries_are_real():
    """Every allowlisted name and parameter exists in the JAX package, and
    every allowlisted parameter is in fact absent from the port's
    signature (a gap closed later leaves no stale entry)."""
    for (mod, qual), params in BY_DESIGN.items():
        jobj = importlib.import_module(mod)
        for part in qual.split("."):
            jobj = getattr(jobj, part)
        if params is None:
            continue
        tobj = importlib.import_module(
            "infercam_onnx_tpu_torch" + mod[len("infercam_onnx_tpu"):])
        for part in qual.split("."):
            tobj = getattr(tobj, part)
        assert params <= _param_names(jobj), (mod, qual)
        assert not params & _param_names(tobj), (mod, qual)


# -- the sub-package and top-level exports ------------------------------------


@pytest.mark.parametrize("package", ["models", "ops"])
def test_subpackage_exports(package):
    """Each name JAX's sub-package imports is the port's object of the
    same name from the port's module of the same path."""
    tpkg = importlib.import_module(f"infercam_onnx_tpu_torch.{package}")
    tree = ast.parse((JAX_ROOT / package / "__init__.py").read_text())
    imports = [n for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert imports, package
    for node in imports:
        port_mod = importlib.import_module(
            "infercam_onnx_tpu_torch" + node.module[len("infercam_onnx_tpu"):])
        for alias in node.names:
            assert getattr(tpkg, alias.asname or alias.name) is getattr(
                port_mod, alias.name), (package, alias.name)


def test_models_export_is_the_model_api():
    from infercam_onnx_tpu_torch.models import (VARIANTS, UltraFace,
                                                forward, generate_priors,
                                                init_params)

    model = UltraFace.create("slim-320", init_params(1, arch="slim"),
                             device="cpu")
    assert VARIANTS["slim-320"] == (model.width, model.height)
    np.testing.assert_array_equal(model.priors.numpy(),
                                  generate_priors(320, 240))
    x = torch.zeros(1, 240, 320, 3)
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(
            model(x), forward(model.params, x, model.priors)))


def test_ops_import_builds_no_kernel():
    """``import infercam_onnx_tpu_torch.ops`` stays cheap: nothing is built
    and no kernel is loaded until the first launch."""
    import subprocess
    import sys

    code = ("import infercam_onnx_tpu_torch.ops as o, sys\n"
            "from infercam_onnx_tpu_torch.ops import nms\n"
            "assert nms.kernel._lib is None, 'kernel loaded at import'\n"
            "assert 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_top_level_lazy_exports():
    import infercam_onnx_tpu as jpkg
    import infercam_onnx_tpu_torch as tpkg

    tree = ast.parse((JAX_ROOT / "__init__.py").read_text())
    lazy = [n for n in _top_level(tree, True) if n[0].isupper()]
    assert "ParallelConfig" in lazy and "UltraFace" in lazy
    for name in lazy:
        assert getattr(jpkg, name).__name__ == getattr(tpkg, name).__name__
    from infercam_onnx_tpu_torch.models.ultraface import UltraFace

    assert tpkg.UltraFace is UltraFace
    with pytest.raises(AttributeError):
        tpkg.NoSuchName  # noqa: B018


def test_parallel_config_matches_jax():
    from infercam_onnx_tpu.config import ParallelConfig as JParallelConfig

    import infercam_onnx_tpu_torch as tpkg
    from infercam_onnx_tpu_torch.config import ParallelConfig

    assert tpkg.ParallelConfig is ParallelConfig
    assert dataclasses.asdict(ParallelConfig()) == dataclasses.asdict(
        JParallelConfig())
    assert [f.name for f in dataclasses.fields(ParallelConfig)] == [
        f.name for f in dataclasses.fields(JParallelConfig)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        ParallelConfig().tile_overlap = 0.5


def test_module_loggers_match_jax():
    from infercam_onnx_tpu import codec as jcodec
    from infercam_onnx_tpu.serving import link as jlink

    from infercam_onnx_tpu_torch import codec as tcodec
    from infercam_onnx_tpu_torch.serving import link as tlink

    assert isinstance(tcodec.log, logging.Logger)
    assert tcodec.log.name == "infercam_onnx_tpu_torch.codec"
    assert jcodec.log.name == "infercam_onnx_tpu.codec"
    assert tlink.log.name == jlink.log.name == "infercam.link"


def test_postprocess_and_model_constants_match_jax():
    from infercam_onnx_tpu.models import ultraface as juf
    from infercam_onnx_tpu.ops import postprocess as jpost

    from infercam_onnx_tpu_torch.models import ultraface as tuf
    from infercam_onnx_tpu_torch.ops import postprocess as tpost

    assert tpost.EPS == jpost.EPS
    assert tuf.BN_EPS == juf.BN_EPS


# -- the small helpers ---------------------------------------------------------


def test_decode_ycbcr_batch_threads_equal_default():
    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.native import jpeg as native_jpeg

    rng = np.random.default_rng(11)
    datas = [codec.encode_rgb(rng.integers(0, 256, (96, 128, 3),
                                           dtype=np.uint8), 90)
             for _ in range(3)]
    shim = native_jpeg.load()
    for scale in (1, 2):
        want, want_geom = shim.decode_ycbcr_batch(datas, scale=scale)
        for threads in (1, 2):
            got, geom = shim.decode_ycbcr_batch(datas, threads, scale=scale)
            np.testing.assert_array_equal(got, want)
            assert geom == want_geom
        got, _ = shim.decode_ycbcr_batch(datas, threads=1, scale=scale)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["native", "graph", "sharded"])
@pytest.mark.parametrize("pack_output", [False, True])
def test_warmup_runs_the_program_asked_for(kind, pack_output, monkeypatch):
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector
    from infercam_onnx_tpu_torch.parallel import ShardedDetector, make_mesh

    from tests.test_goldens_fixtures import WEIGHTS

    config = DetectorConfig(compute_dtype="float32")
    if kind == "graph":
        det = GraphDetector(str(TWIN_ONNX), config, device="cpu")
    else:
        det = Detector(config, weights=str(WEIGHTS), device="cpu")
    if kind == "sharded":
        det = ShardedDetector(det, make_mesh(2, device="cpu"))
    calls = []
    run_device = det.run_device

    def spy(images, *, pack_output=False):
        out = run_device(images, pack_output=pack_output)
        calls.append((tuple(images.shape), pack_output, out))
        return out

    monkeypatch.setattr(det, "run_device", spy)
    if pack_output:
        det.warmup(2, 48, 64, pack_output=True)
    else:
        det.warmup(2, 48, 64)
    ((shape, packed, out),) = calls
    assert shape == (2, 48, 64, 3) and packed is pack_output
    if pack_output:
        assert out.shape == (2, config.max_detections, 6)
    else:
        assert len(out) == 3 and out[0].shape == (2, config.max_detections,
                                                  4)


def test_format_drain_matches_jax():
    from infercam_onnx_tpu.utils.profiling import StageTimer as JStageTimer

    from infercam_onnx_tpu_torch.utils.profiling import StageTimer

    rng = np.random.default_rng(3)
    samples = [("decode", float(s)) for s in rng.uniform(1e-3, 9e-3, 40)]
    samples += [("device", float(s)) for s in rng.uniform(2e-3, 5e-3, 25)]
    samples += [("encode", 0.0125)]
    jt, tt = JStageTimer(), StageTimer()
    for name, seconds in samples:
        jt.record(name, seconds)
        tt.record(name, seconds)
    want = jt.format_drain()
    assert tt.format_drain() == want
    assert want.startswith("decode p50 ") and "; device p50 " in want
    assert "encode p50 12.5ms p95 12.5ms x1" in want
    assert tt.format_drain() == jt.format_drain() == ""  # drained


def test_close_all_closes_every_subscription():
    from infercam_onnx_tpu.serving.broadcast import Broadcast as JBroadcast

    from infercam_onnx_tpu_torch.serving.broadcast import Broadcast

    async def run(cls):
        channel = cls(capacity=4)
        subs = [channel.subscribe() for _ in range(3)]
        channel.publish(b"last")
        channel.close_all()
        got = []
        for sub in subs:
            got.append(await sub.receive())  # what the ring held
            with pytest.raises(BrokenPipeError):
                await sub.receive()
        return channel.receiver_count, got, channel.publish(b"after")

    assert asyncio.run(run(Broadcast)) == asyncio.run(run(JBroadcast)) == (
        0, [b"last"] * 3, 0)


class _Writer:
    """The StreamWriter surface a connection handler uses."""

    def __init__(self):
        self.closed = False
        self.transport = None

    def get_extra_info(self, name):
        return ("127.0.0.1", 5555) if name == "peername" else None

    def close(self):
        self.closed = True


def test_handle_incoming_queues_what_jax_queues():
    from infercam_onnx_tpu import protocol as jproto
    from infercam_onnx_tpu.serving.data_socket import (
        handle_incoming as jax_handle_incoming)

    from infercam_onnx_tpu_torch import protocol
    from infercam_onnx_tpu_torch.serving.data_socket import handle_incoming

    msgs = [protocol.ConnectReq("cam"),
            protocol.FrameMsg("cam", b"\xff\xd8jpeg-0\xff\xd9"),
            protocol.FrameMsg("other", b"\xff\xd8jpeg-1\xff\xd9")]
    wire = b"".join(protocol.frame_encode(protocol.encode_proto_msg(m))
                    for m in msgs)
    assert wire == b"".join(jproto.frame_encode(jproto.encode_proto_msg(
        getattr(jproto, type(m).__name__)(*dataclasses.astuple(m))))
        for m in msgs)

    async def run(handle):
        reader = asyncio.StreamReader()
        reader.feed_data(wire)
        reader.feed_eof()
        queue: asyncio.Queue = asyncio.Queue(maxsize=8)
        writer = _Writer()
        await handle(reader, writer, queue)
        out = []
        while not queue.empty():
            out.append(queue.get_nowait())
        return out, writer.closed

    got, closed = asyncio.run(run(handle_incoming))
    want, jax_closed = asyncio.run(run(jax_handle_incoming))
    assert got == want and closed and jax_closed
    assert [protocol.decode_proto_msg(p) for p in got] == msgs


def test_serve_forever_answers_then_cancels():
    from infercam_onnx_tpu_torch.config import ServerConfig
    from infercam_onnx_tpu_torch.serving.http import HttpServer
    from infercam_onnx_tpu_torch.serving.router import FrameRouter

    async def run():
        router = FrameRouter(lambda job: True, ServerConfig())
        http = HttpServer(router)
        await http.start("127.0.0.1", 0)
        task = asyncio.ensure_future(http.serve_forever())
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       http.port)
        writer.write(b"GET /healthcheck HTTP/1.1\r\nHost: x\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        reply = await asyncio.wait_for(reader.read(), 10)
        writer.close()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        listening = http._server.is_serving()
        await http.close()
        return reply, listening

    reply, listening = asyncio.run(run())
    assert reply.startswith(b"HTTP/1.1 200")
    assert not listening


def test_ingest_queue_is_the_data_sockets_queue(monkeypatch):
    from infercam_onnx_tpu_torch.config import (DetectorConfig, EngineConfig,
                                                ServerConfig)
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.serving import app

    from tests.test_goldens_fixtures import WEIGHTS

    given = []
    spawn = app.spawn_data_socket

    async def capture(queue, host, port):
        given.append(queue)
        return await spawn(queue, host, port)

    monkeypatch.setattr(app, "spawn_data_socket", capture)
    det = Detector(DetectorConfig(compute_dtype="float32"),
                   weights=str(WEIGHTS), device="cpu")

    async def run():
        server = await app.start_server(
            ServerConfig(http_address="127.0.0.1:0",
                         socket_address="127.0.0.1:0", ingest_capacity=7),
            engine_config=EngineConfig(batch_buckets=(1,),
                                       link_adaptive=False),
            detector=det)
        try:
            return server.ingest_queue
        finally:
            await server.close()

    queue = asyncio.run(run())
    assert given == [queue]
    assert isinstance(queue, asyncio.Queue) and queue.maxsize == 7


def test_graph_executor_initializers_match_jax():
    """``executor(*inputs, initializers=)`` substitutes weights for one
    call, as the JAX executor's does, also where the build folded a value
    from them (``W2 = W * 2``) and inside an If branch (``W * W``); a call
    without it still runs the graph's own weights."""
    from infercam_onnx_tpu.models import onnx_exec as jexec
    from infercam_onnx_tpu.models import onnx_reader as jr

    from infercam_onnx_tpu_torch.models import onnx_exec as texec
    from infercam_onnx_tpu_torch.models import onnx_reader as tr

    rng = np.random.default_rng(21)
    inits = {"W": rng.normal(size=(4, 3)).astype(np.float32),
             "B": rng.normal(size=(3,)).astype(np.float32),
             "two": np.float32(2.0), "c": np.array(True)}

    def graph(m):
        branch = m.OnnxGraph(
            nodes=[m.OnnxNode("Mul", "sq", ["W", "W"], ["WW"], {})],
            initializers={}, inputs=[],
            outputs=[m.OnnxValueInfo("WW", 1, [4, 3])])
        nodes = [("Mul", "dbl", ["W", "two"], ["W2"], {}),
                 ("MatMul", "mm", ["x", "W2"], ["y0"], {}),
                 ("Add", "add", ["y0", "B"], ["y"], {}),
                 ("If", "if", ["c"], ["z"],
                  {"then_branch": branch, "else_branch": branch})]
        return m.OnnxGraph(
            nodes=[m.OnnxNode(*n) for n in nodes],
            initializers=dict(inits),
            inputs=[m.OnnxValueInfo("x", 1, [2, 4])],
            outputs=[m.OnnxValueInfo("y", 1, [2, 3]),
                     m.OnnxValueInfo("z", 1, [4, 3])])

    x = rng.normal(size=(2, 4)).astype(np.float32)
    w_new = rng.normal(size=(4, 3)).astype(np.float32)
    jx = jexec.GraphExecutor(graph(jr))
    tx = texec.GraphExecutor(graph(tr))
    want = [np.asarray(v) for v in jx(x, initializers={"W": w_new})]
    got = tx(torch.from_numpy(x), initializers={"W": torch.from_numpy(w_new)})
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got[0]),
                               x @ (w_new * 2) + inits["B"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got[1]), w_new * w_new)
    # without it, the graph's own weights (values the build folded stay
    # NumPy)
    plain = [np.asarray(v) for v in jx(x)]
    for g, w in zip(tx(torch.from_numpy(x)), plain):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-6, atol=1e-6)
    # NumPy weights, a second call on the cached substituting executor
    again = tx(torch.from_numpy(x), initializers={"W": w_new})
    for a, b in zip(again, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(tx._substituting) == 1
