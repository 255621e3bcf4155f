"""The port's parity metrics, NumPy reference oracle and goldens CLI against
the JAX package's.

- ``ops/reference_impl.py`` equals JAX's on seeded random candidates
  exactly (same boxes, same confidences, same order);
- ``eval/parity.py`` (``match_detections``, ``parity_report``,
  ``fidelity_gate(min_parity=)``) equals JAX's exactly on the same sets;
- ``eval.goldens.main(["check", ...])`` on the committed RFB-320 synthetic
  fixture prints JAX's counts and parities and returns JAX's exit code;
  ``make`` writes a fixture whose detections are within ROADMAP C.3 of
  JAX's ``make`` (float32: counts equal, boxes within 1e-5, confidences
  within 5e-5); an explicit ``resize`` wins over the fixture's.

The CLIs run on the CPU (``--device cpu``) under the offline weights chain
of `torch_port_offline`.
"""

import json

import numpy as np
import pytest

from infercam_onnx_tpu.eval import goldens as jgoldens
from infercam_onnx_tpu.eval import parity as jparity
from infercam_onnx_tpu.ops import reference_impl as jref
from infercam_onnx_tpu.utils import cache as jcache
from infercam_onnx_tpu_torch.eval import goldens, parity
from infercam_onnx_tpu_torch.ops import reference_impl as ref

from tests.test_goldens_fixtures import FIXTURES, SYNTH_PICS, WEIGHTS
from torch_port_offline import offline_weights_chain  # noqa: E402,F401

FIXTURE = FIXTURES / "goldens_twin_rfb320_synthetic.json"
C3 = (1e-5, 5e-5)  # ROADMAP C.3: boxes, confidences
CHECK = ["--dir", str(SYNTH_PICS), "--variant", "RFB-320",
         "--compute-dtype", "float32"]


def _candidates(seed: int, k: int):
    """Clustered boxes (some ill-formed) and scores around 0.5, with ties."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, size=(5, 2))
    c = centers[rng.integers(0, 5, size=k)] + rng.normal(0, 0.03, (k, 2))
    wh = rng.uniform(-0.02, 0.2, size=(k, 2))  # a few negative: ill-formed
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    conf = rng.uniform(0.3, 1.0, size=k).astype(np.float32)
    conf[rng.integers(0, k, size=k // 8)] = conf[0]  # ties
    scores = np.stack([1 - conf, conf], -1)
    return scores, boxes


def _same(got, want) -> None:
    assert len(got) == len(want)
    for (gb, gc), (wb, wc) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        assert gc == wc


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("min_confidence,max_iou",
                         [(0.5, 0.5), (0.7, 0.3), (0.35, 0.0)])
def test_reference_postprocess_equals_jax(seed, min_confidence, max_iou):
    scores, boxes = _candidates(seed, 200)
    got = ref.postprocess(scores, boxes, min_confidence, max_iou)
    want = jref.postprocess(scores, boxes, min_confidence, max_iou)
    _same(got, want)
    assert got  # the filter kept candidates
    conf = scores[:, 1]
    cands = sorted(((boxes[i], float(conf[i])) for i in range(len(conf))
                    if conf[i] > min_confidence), key=lambda t: t[1])
    _same(ref.non_maximum_suppression(cands, max_iou),
          jref.non_maximum_suppression(cands, max_iou))


def test_reference_iou_and_area_equal_jax():
    _, boxes = _candidates(7, 64)
    assert ref.EPS == jref.EPS
    for a in boxes[:16]:
        assert ref.bbox_area(a) == jref.bbox_area(a)
        for b in boxes:
            assert ref.iou(a, b) == jref.iou(a, b)


def _sets(seed: int, images: int = 5):
    """Two related detection sets: ``want`` and a perturbed ``got`` with
    misses and extras."""
    rng = np.random.default_rng(seed)
    want, got = [], []
    for _ in range(images):
        n = int(rng.integers(0, 8))
        w = [(rng.uniform(0, 0.6, 2).tolist(), float(rng.uniform(0.5, 1)))
             for _ in range(n)]
        w = [(np.array(xy + [xy[0] + 0.3, xy[1] + 0.3], np.float32), c)
             for xy, c in w]
        g = [(b + rng.normal(0, 0.03, 4).astype(np.float32),
              c + float(rng.normal(0, 0.02)))
             for b, c in w if rng.uniform() > 0.15]
        g += [(np.array([0.7, 0.7, 0.9, 0.9], np.float32), 0.6)
              ] * int(rng.integers(0, 2))
        want.append(w)
        got.append(g)
    return got, want


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("iou_thresh,conf_tol", [(0.5, 0.02), (0.8, 0.05)])
def test_parity_equals_jax(seed, iou_thresh, conf_tol):
    got, want = _sets(seed)
    for g, w in zip(got, want):
        assert (parity.match_detections(g, w, iou_thresh)
                == jparity.match_detections(g, w, iou_thresh))
    report = parity.parity_report(got, want, iou_thresh=iou_thresh,
                                  conf_tol=conf_tol)
    jreport = jparity.parity_report(got, want, iou_thresh=iou_thresh,
                                    conf_tol=conf_tol)
    assert report.as_dict() == jreport.as_dict()
    for min_parity in (0.0, 0.5, 0.8, 0.95, 1.0):
        assert (parity.fidelity_gate(report, min_parity)
                == jparity.fidelity_gate(jreport, min_parity))
    assert parity.fidelity_gate(report) == jparity.fidelity_gate(jreport)


def test_eval_exports_the_jax_names():
    from infercam_onnx_tpu import eval as jeval
    from infercam_onnx_tpu_torch import eval as teval

    names = ("fidelity_gate", "match_detections", "parity_report")
    assert all(hasattr(teval, n) for n in names)
    assert {n for n in dir(jeval) if not n.startswith("_")} - {
        "goldens", "parity"} == set(names)
    assert goldens.parity_report is parity.parity_report


@pytest.fixture()
def no_xla_cache(monkeypatch):
    """The JAX CLI's persistent-cache switch left alone (it would point
    XLA at the temporary user cache)."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)


def _run(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("extra", [
    ["--weights", str(WEIGHTS)],
    ["--weights", str(WEIGHTS), "--min-parity", "0.99"],
    [],  # the weights chain: offline, the seeded random weights fail
])
def test_check_cli_equals_jax(extra, no_xla_cache, capsys):
    argv = ["check", *CHECK, "--goldens", str(FIXTURE), *extra]
    rc, out = _run(goldens.main, [*argv, "--device", "cpu"], capsys)
    jrc, jout = _run(jgoldens.main, argv, capsys)
    got, want = json.loads(out), json.loads(jout)
    assert rc == jrc == (0 if got["passed"] else 1)
    assert got == want
    assert got["passed"] == bool(extra)


def _table_within(got: dict, want: dict, tols) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.array(got[name]), np.array(want[name])
        assert g.shape == w.shape, name
        if w.size:
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0,
                                       atol=tols[0])
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0,
                                       atol=tols[1])


@pytest.mark.parametrize("resize", [None, "320x240"])
def test_make_cli_within_c3_of_jax(resize, tmp_path, no_xla_cache, capsys):
    flags = [*CHECK, "--weights", str(WEIGHTS)]
    if resize:
        flags += ["--resize", resize]
    out, jout = tmp_path / "port.json", tmp_path / "jax.json"
    rc, line = _run(goldens.main, ["make", *flags, "--out", str(out),
                                   "--device", "cpu"], capsys)
    jrc, jline = _run(jgoldens.main, ["make", *flags, "--out", str(jout)],
                      capsys)
    assert rc == jrc == 0
    assert line.replace(str(out), "") == jline.replace(str(jout), "")
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert (got["variant"], got["resize"]) == (want["variant"],
                                               want["resize"])
    _table_within(got["detections"], want["detections"], C3)
    assert sum(map(len, got["detections"].values())) >= 10
    # the port checks its own fixture at parity 1.0
    rc, line = _run(goldens.main, ["check", *CHECK, "--weights",
                                   str(WEIGHTS), "--goldens", str(out),
                                   "--device", "cpu"], capsys)
    result = json.loads(line)
    assert rc == 0 and result["box_parity"] == result["conf_parity"] == 1.0


@pytest.mark.parametrize("explicit", [None, (320, 240)])
def test_explicit_resize_wins_over_the_fixtures(explicit, tmp_path,
                                                monkeypatch):
    fixture = tmp_path / "g.json"
    fixture.write_text(json.dumps({"variant": "RFB-320", "resize": [640, 480],
                                   "detections": {}}))
    seen = {}
    for name, module in (("port", goldens), ("jax", jgoldens)):
        def detect_directory(detector, directory, resize=None, name=name):
            seen[name] = resize
            return {}

        monkeypatch.setattr(module, "detect_directory", detect_directory)
        module.check_against_goldens(None, str(SYNTH_PICS), str(fixture),
                                     resize=explicit)
    assert seen["port"] == seen["jax"] == (explicit or (640, 480))


@pytest.mark.parametrize("argv", [["make", "--dir", str(SYNTH_PICS)],
                                  ["check", "--dir", str(SYNTH_PICS)]])
def test_cli_argument_errors_equal_jax(argv, no_xla_cache, capsys):
    flags = ["--variant", "RFB-320", "--weights", str(WEIGHTS)]
    with pytest.raises(SystemExit) as got:
        goldens.main([*argv, *flags, "--device", "cpu"])
    err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as want:
        jgoldens.main([*argv, *flags])
    jerr = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert err.split("error: ")[1] == jerr.split("error: ")[1]


def test_load_goldens_and_detection_sets_equal_jax():
    table = goldens.load_goldens(str(FIXTURE))
    assert table == jgoldens.load_goldens(str(FIXTURE))
    names = sorted(table) + ["absent.jpg"]
    got = goldens.as_detection_sets(table, names)
    want = jgoldens.as_detection_sets(table, names)
    assert len(got) == len(want) and got[-1] == want[-1] == []
    for g, w in zip(got, want):
        _same(g, w)
