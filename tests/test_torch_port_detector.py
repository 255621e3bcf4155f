"""The port's whole detect path against the JAX package, its goldens gate,
its CLI, its device rule, and its import boundary.

The packed detections of the four synthetic pictures under the frozen
weights at float32 must equal the JAX ``detect_program``'s: counts and
valid rows equal, boxes within 1e-5, confidences within 5e-5. The two
CPU conv trunks sum in different orders, which moves a logit of
magnitude ~10 by ~1e-4; near a score of 0.5 the softmax's slope (0.25)
turns that into up to 2.8e-5 (seen on synthetic-1, score 0.5036).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infercam_onnx_tpu import detector as jdet
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.models import ultraface as juf
from infercam_onnx_tpu.ops.preprocess import Preprocessor as JPreprocessor
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch import detect as tdetect
from infercam_onnx_tpu_torch import detector as tdet
from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.eval import goldens as tgoldens

from tests.test_goldens_fixtures import FIXTURES, SYNTH_PICS, WEIGHTS
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = DetectorConfig(compute_dtype="float32", top_k=512,
                        max_detections=256)


@pytest.fixture(scope="module")
def frames():
    return np.stack(list(tgoldens.load_directory_frames(
        str(SYNTH_PICS)).values()))


@pytest.fixture(scope="module")
def port_detector():
    return tdet.Detector(CONFIG, weights=str(WEIGHTS), device="cpu")


def test_packed_output_matches_jax(frames, port_detector):
    params = jconvert.params_from_state_dict(dict(np.load(WEIGHTS)))
    r_h, r_w = JPreprocessor(320, 240).matrices(640, 480)
    want = np.asarray(jdet.detect_program(
        params, jnp.asarray(juf.generate_priors(320, 240)),
        jnp.asarray(frames), r_h, r_w, compute_dtype=jnp.float32,
        min_confidence=CONFIG.min_confidence, max_iou=CONFIG.max_iou,
        top_k=CONFIG.top_k, max_detections=CONFIG.max_detections,
        pack_output=True))
    got = port_detector.run_device(frames, pack_output=True)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (4, 256, 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])  # counts
    assert want[..., 5].sum() >= 10  # the fixture has faces to find
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=5e-5)


def test_unpacked_output_and_host_api(frames, port_detector):
    boxes, confs, counts = port_detector.run_device(frames)
    packed = tdet.pack_detections(boxes, confs, counts).numpy()
    per_frame = port_detector.detect_batch(frames)
    assert [len(d) for d in per_frame] == counts.tolist()
    assert tdet.unpack_detections(packed)[0][0][1] == per_frame[0][0][1]
    one = port_detector.detect(frames[2])
    assert len(one) == len(per_frame[2])
    for (b1, c1), (b2, c2) in zip(one, per_frame[2]):
        np.testing.assert_array_equal(b1, b2)
        assert c1 == c2


def test_goldens_gate_passes(port_detector):
    result = tgoldens.check_against_goldens(
        port_detector, str(SYNTH_PICS),
        str(FIXTURES / "goldens_twin_rfb320_synthetic.json"))
    assert result["want_total"] >= 10
    assert result["passed"], result


def test_goldens_gate_fails_a_wrong_detector(tmp_path):
    """The gate has teeth: a detector thresholded above every golden
    confidence finds nothing and fails."""
    det = tdet.Detector(
        DetectorConfig(compute_dtype="float32", min_confidence=0.9999),
        weights=str(WEIGHTS), device="cpu")
    result = tgoldens.check_against_goldens(
        det, str(SYNTH_PICS),
        str(FIXTURES / "goldens_twin_rfb320_synthetic.json"))
    assert not result["passed"]


def test_random_weights_follow_the_seed():
    a = tdet.Detector(DetectorConfig(variant="slim-320"), rng=3,
                      device="cpu")
    want = juf.init_params(3, background_bias=0.75, arch="slim")
    assert isinstance(a.model.base[7], type(a.model.base[8]))  # slim
    w = a.model.base[0].w
    assert w.dtype == torch.bfloat16  # the default compute dtype
    np.testing.assert_array_equal(
        w.float().numpy(),
        torch.from_numpy(np.transpose(want["base"][0]["w"], (3, 2, 0, 1)))
        .to(torch.bfloat16).float().numpy())


def test_default_device_is_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: Detector() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.Detector()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdetect.main([str(SYNTH_PICS / "synthetic-0.jpg")])


def test_detect_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "out.jpg"
    rc = tdetect.main([str(SYNTH_PICS / "synthetic-0.jpg"), "-o", str(out),
                       "--weights", str(WEIGHTS), "--device", "cpu",
                       "--top-k", "512", "--max-detections", "256"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu"
    frame = codec.decode_rgb((SYNTH_PICS / "synthetic-0.jpg").read_bytes())
    want = tdet.Detector(DetectorConfig(top_k=512, max_detections=256),
                         weights=str(WEIGHTS), device="cpu").detect(frame)
    assert report["faces"] == len(want) > 0
    for row, (bbox, conf) in zip(report["detections"], want):
        assert row["bbox"] == [float(v) for v in bbox]
        assert row["confidence"] == conf
    annotated = codec.decode_rgb(out.read_bytes())
    assert annotated.shape == (480, 640, 3)


def test_draw_uses_the_ports_own_font():
    """draw.py reads the DejaVu font from the port's own resources/ (its
    licence beside it), not from the JAX package, and draws exactly what
    the JAX package's draw_detections draws."""
    from infercam_onnx_tpu import draw as jdraw
    from infercam_onnx_tpu_torch import draw as tdraw

    pkg = REPO / "infercam_onnx_tpu_torch"
    font = pathlib.Path(tdraw._FONT_PATH)
    assert font.parent == pkg / "resources" and font.is_file()
    assert (pkg / "resources" / "LICENSE_DEJAVU").is_file()
    assert font.read_bytes() == (
        REPO / "infercam_onnx_tpu" / "resources" / "DejaVuSansMono.ttf"
    ).read_bytes()
    assert tdraw._font().path == str(font)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, size=(120, 160, 3), dtype=np.uint8)
    dets = [(np.array([0.1, 0.2, 0.5, 0.7], np.float32), 0.875),
            (np.array([0.4, 0.05, 0.95, 0.5], np.float32), 0.51234)]
    np.testing.assert_array_equal(tdraw.draw_detections(frame, dets),
                                  jdraw.draw_detections(frame, dets))


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, pulls in
    neither jax nor any module of the JAX package."""
    pkg = REPO / "infercam_onnx_tpu_torch"
    modules = sorted(
        "infercam_onnx_tpu_torch." + ".".join(
            p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        "import chip_smoke, infercam_onnx_tpu_torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'infercam_onnx_tpu' or m.startswith('infercam_onnx_tpu.')]"
        "\nprint(json.dumps({'n': len(sys.modules), 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(modules) >= 12
    assert result["bad"] == []


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root.startswith("jax") or root == "infercam_onnx_tpu"


def _imports(tree: ast.AST):
    """(line, module) of every import in ``tree``, at any depth: import
    statements inside functions included, and importlib.import_module /
    __import__ calls with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else getattr(fn, "id", ""))
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_port_sources_import_no_jax_at_any_depth():
    """Every .py of the port, and chip_smoke.py, read as source: no
    import of jax or of the JAX package anywhere in them, including the
    imports inside functions that only run on some paths (the subprocess
    test above sees only what importing the modules pulls in). The
    package's modules (the bench and the microbench among them) import
    neither ``tests`` nor ``chip_smoke`` either."""
    package = sorted((REPO / "infercam_onnx_tpu_torch").rglob("*.py"))
    assert len(package) >= 25
    assert {"bench.py", "microbench.py"} <= {p.name for p in package}
    bad = [f"{path.relative_to(REPO)}:{line}: {module}"
           for path in [*package, REPO / "chip_smoke.py"]
           for line, module in _imports(ast.parse(path.read_text()))
           if _forbidden(module) or (path in package and module.split(
               ".")[0] in ("tests", "chip_smoke"))]
    assert bad == []
    # the scan sees lazy imports and import_module calls
    probe = ast.parse("def f():\n    import jax.numpy\n"
                      "    from infercam_onnx_tpu.serving import link\n"
                      "    importlib.import_module('jaxlib')\n")
    assert [m for _, m in _imports(probe) if _forbidden(m)] == [
        "jax.numpy", "infercam_onnx_tpu.serving", "jaxlib"]
