"""The port's weights chain against the JAX package's: the converted .npz
cache, the cached or downloaded ONNX file, then random weights.

Every case runs under a ``XDG_CACHE_HOME`` of its own (a temporary
directory) with the downloaders stubbed offline (`torch_port_offline`),
or pointed at an HTTP server on 127.0.0.1, port 0. With the committed
twin export in the cache, the port's ``Detector()`` must give JAX's
``Detector()``'s packed output by ROADMAP C.3 (float32: counts equal,
boxes within 1e-5, confidences within 5e-5) and its own output with the
export's params passed explicitly bit for bit. The .npz files each
package writes must read back in the other to equal arrays.
"""

import functools
import http.server
import json
import logging
import pathlib
import shutil
import socket
import threading

import jax
import numpy as np
import pytest

from infercam_onnx_tpu import detect as jdetect
from infercam_onnx_tpu import detector as jdet
from infercam_onnx_tpu.config import DetectorConfig as JDetectorConfig
from infercam_onnx_tpu.models import checkpoint as jcheckpoint
from infercam_onnx_tpu.models import convert as jconvert
from infercam_onnx_tpu.models import ultraface as juf
from infercam_onnx_tpu.utils import cache as jcache
from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch import detect as tdetect
from infercam_onnx_tpu_torch.config import DetectorConfig
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.eval.goldens import load_directory_frames
from infercam_onnx_tpu_torch.models import checkpoint, convert
from infercam_onnx_tpu_torch.models import ultraface as uf
from infercam_onnx_tpu_torch.utils import cache
from infercam_onnx_tpu_torch.utils.download import download_file

from tests.test_goldens_fixtures import FIXTURES, SYNTH_PICS, WEIGHTS
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

TWIN_ONNX = FIXTURES / "ultraface_twin_rfb320.onnx"
C3 = (1e-5, 5e-5)  # ROADMAP C.3: boxes, confidences


@pytest.fixture()
def cache_home(tmp_path, monkeypatch):
    """An empty user cache of this test's own."""
    home = tmp_path / "xdg"
    monkeypatch.setenv("XDG_CACHE_HOME", str(home))
    return home


@pytest.fixture(scope="module")
def frames():
    return np.stack(list(load_directory_frames(str(SYNTH_PICS)).values()))


def _leaves(tree) -> list[np.ndarray]:
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def _assert_trees_equal(got, want) -> None:
    assert (jax.tree.structure(jax.tree.map(np.asarray, got))
            == jax.tree.structure(jax.tree.map(np.asarray, want)))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _assert_packed_within(got: np.ndarray, want: np.ndarray, tols) -> None:
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=tols[0])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0,
                               atol=tols[1])


def _cache_twin(variant: str = "RFB-320") -> str:
    path = convert.cached_model_path(variant)
    shutil.copyfile(TWIN_ONNX, path)
    return path


def test_cache_paths_are_the_jax_packages(cache_home):
    assert cache.cache_dir("weights") == jcache.cache_dir("weights") == str(
        cache_home / "infercam_onnx_tpu" / "weights")
    for variant in convert.ULTRAFACE_URLS:
        assert (convert.cached_model_path(variant)
                == jconvert.cached_model_path(variant))
    assert convert.ULTRAFACE_URLS == jconvert.ULTRAFACE_URLS


def test_detector_takes_the_cached_onnx_like_jax(cache_home, frames):
    """The repair: with the twin export cached, Detector() without weights
    runs the twin, as JAX's Detector() does, and writes the .npz cache."""
    _cache_twin()
    config = DetectorConfig(compute_dtype="float32")
    got = Detector(config, device="cpu").run_device(
        frames, pack_output=True).numpy()
    npz = cache_home / "infercam_onnx_tpu" / "weights" / "ultraface-RFB-320.npz"
    assert npz.is_file()
    explicit = Detector(config, params=convert.params_from_onnx(
        str(TWIN_ONNX)), device="cpu").run_device(
            frames, pack_output=True).numpy()
    np.testing.assert_array_equal(got, explicit)
    assert got[..., 5].sum() >= 10  # the twin finds faces; random does not
    # JAX's Detector() reads the .npz the port wrote
    want = np.asarray(jdet.Detector(JDetectorConfig(
        compute_dtype="float32")).run_device(frames, pack_output=True))
    _assert_packed_within(got, want, C3)
    # a second port detector reads the cache, bit-identical again
    again = Detector(config, device="cpu").run_device(
        frames, pack_output=True).numpy()
    np.testing.assert_array_equal(again, got)


def test_detect_cli_without_weights_takes_the_cached_onnx(cache_home,
                                                          tmp_path, capsys):
    """`detect` with no --weights: the port's CLI runs the cached twin, as
    the JAX CLI does (both bfloat16; the face counts agree, and the port's
    detections equal its Detector on the twin's params bit for bit)."""
    _cache_twin()
    img = tmp_path / "in.jpg"
    img.write_bytes((SYNTH_PICS / "synthetic-0.jpg").read_bytes())
    assert tdetect.main([str(img), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jdetect.main([str(img)]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["faces"] == want["faces"] >= 1
    det = Detector(DetectorConfig(), device="cpu",
                   params=convert.params_from_onnx(str(TWIN_ONNX)))
    dets = det.detect(codec.decode_rgb(img.read_bytes()))
    assert [d["bbox"] for d in got["detections"]] == [
        [float(v) for v in box] for box, _ in dets]
    assert [d["confidence"] for d in got["detections"]] == [
        c for _, c in dets]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_caches_are_interchangeable(tmp_path, writer):
    params = convert.params_from_onnx(str(TWIN_ONNX))
    path = str(tmp_path / "params.npz")
    if writer == "port":
        checkpoint.save_params(params, path)
        _assert_trees_equal(jcheckpoint.load_params(path), params)
    else:
        jcheckpoint.save_params(jconvert.params_from_onnx(str(TWIN_ONNX)),
                                path)
        _assert_trees_equal(checkpoint.load_params(path), params)
    # both write the same keys and arrays
    other = str(tmp_path / "other.npz")
    (jcheckpoint.save_params if writer == "port"
     else checkpoint.save_params)(params, other)
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_save_params_takes_tensor_leaves(tmp_path):
    import torch

    params = uf.init_params(1, background_bias=0.75, arch="RFB")
    tensors = jax.tree.map(torch.from_numpy, params)
    path = str(tmp_path / "t.npz")
    checkpoint.save_params(tensors, path)
    _assert_trees_equal(checkpoint.load_params(path), params)


def test_corrupt_npz_cache_is_rebuilt(cache_home, frames, caplog):
    _cache_twin()
    npz = pathlib.Path(cache.cache_dir("weights"), "ultraface-RFB-320.npz")
    checkpoint.save_params(convert.params_from_onnx(str(TWIN_ONNX)), str(npz))
    npz.write_bytes(npz.read_bytes()[:1000])  # truncated
    config = DetectorConfig(compute_dtype="float32")
    with caplog.at_level(logging.WARNING):
        got = Detector(config, device="cpu").run_device(
            frames[:1], pack_output=True).numpy()
    assert "corrupt weights cache" in caplog.text
    _assert_trees_equal(checkpoint.load_params(str(npz)),
                        convert.params_from_onnx(str(TWIN_ONNX)))
    want = Detector(config, params=convert.params_from_onnx(str(TWIN_ONNX)),
                    device="cpu").run_device(frames[:1],
                                             pack_output=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["garbage", "truncated", "not_ultraface"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_corrupt_cached_onnx_is_quarantined(cache_home, kind, package):
    data = TWIN_ONNX.read_bytes()
    data = {"garbage": b"not an onnx file" * 8,
            "truncated": data[:len(data) // 2],
            "not_ultraface": (FIXTURES / "crnn_opset13.onnx").read_bytes()
            }[kind]
    mod = convert if package == "port" else jconvert
    path = mod.cached_model_path("RFB-320")
    with open(path, "wb") as f:
        f.write(data)
    assert mod.load_or_download_params("RFB-320") is None
    with open(path + ".bad", "rb") as f:
        assert f.read() == data
    assert not (cache_home / "infercam_onnx_tpu"
                / "ultraface-RFB-320.onnx").exists()


@pytest.fixture()
def http_dir(tmp_path):
    """A directory served over HTTP on 127.0.0.1, port 0: (dir, base URL)."""
    root = tmp_path / "www"
    root.mkdir()

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=str(root)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield root, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
        assert not thread.is_alive()


def test_download_file_fetches_over_http(http_dir, tmp_path):
    root, base = http_dir
    shutil.copyfile(TWIN_ONNX, root / "twin.onnx")
    target = tmp_path / "got.onnx"
    download_file(f"{base}/twin.onnx", str(target))
    assert target.read_bytes() == TWIN_ONNX.read_bytes()
    assert not (tmp_path / "got.onnx.part").exists()


def test_download_from_an_unreachable_url_leaves_no_file(tmp_path):
    with socket.socket() as s:  # a port with nothing listening
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    target = tmp_path / "got.onnx"
    with pytest.raises(OSError):
        download_file(f"http://127.0.0.1:{port}/twin.onnx", str(target),
                      timeout=5.0)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("package", ["port", "jax"])
def test_download_on_miss_through_the_seam(cache_home, http_dir, package):
    """A miss calls ``download(url, path)`` with the variant's URL; here
    it fetches the twin from the local server into the cache path."""
    root, base = http_dir
    shutil.copyfile(TWIN_ONNX, root / "twin.onnx")
    asked = []

    def fetch(url, path):
        asked.append(url)
        download_file(f"{base}/twin.onnx", path)

    mod = convert if package == "port" else jconvert
    params = mod.load_or_download_params("RFB-320", download=fetch)
    assert asked == [convert.ULTRAFACE_URLS["RFB-320"]]
    _assert_trees_equal(params, convert.params_from_onnx(str(TWIN_ONNX)))
    # a hit does not download again
    assert mod.load_or_download_params("RFB-320",
                                       download=asked.append) is not None
    assert len(asked) == 1


def test_offline_chain_ends_in_random_weights(cache_home, caplog):
    """No cache, a failing download: the seeded random weights, with JAX's
    warning, and nothing written to the cache."""
    with caplog.at_level(logging.WARNING):
        det = Detector(DetectorConfig(variant="slim-320",
                                      compute_dtype="float32"), rng=5,
                       device="cpu")
    assert "weights unavailable (offline)" in caplog.text
    want = juf.init_params(5, background_bias=0.75, arch="slim")
    np.testing.assert_array_equal(
        det.model.base[0].w.numpy(),
        np.transpose(want["base"][0]["w"], (3, 2, 0, 1)))
    assert convert.load_or_download_params("slim-320") is None
    assert list((cache_home / "infercam_onnx_tpu" / "weights").iterdir()) == []


@pytest.mark.parametrize("arch", ["RFB", "slim"])
def test_state_dict_from_params_matches_jax(arch):
    params = uf.init_params(3, background_bias=0.75, arch=arch)
    got = convert.state_dict_from_params(params)
    want = jconvert.state_dict_from_params(
        jax.tree.map(np.asarray, juf.init_params(3, background_bias=0.75,
                                                 arch=arch)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # and back: the upstream names load into the same pytree
    _assert_trees_equal(convert.params_from_state_dict(got),
                        jax.tree.map(np.asarray, jconvert.params_from_state_dict(
                            want)))


def test_state_dict_round_trips_the_twin():
    params = convert.params_from_state_dict(dict(np.load(WEIGHTS)))
    _assert_trees_equal(convert.params_from_state_dict(
        convert.state_dict_from_params(params)), params)
