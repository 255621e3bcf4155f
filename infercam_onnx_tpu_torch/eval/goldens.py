"""Golden detection fixtures: make, check and the parity gate (the port of
``infercam_onnx_tpu/eval/goldens.py``).

The fixtures replace and extend the reference's only behavioural oracle
(exact face counts over resources/test_pics, reference
infer_server/tests/integration_tests.rs:20-34) with stored per-box
goldens and the >=95% parity gate of ``eval/parity.py``. A fixture is a
JSON file ``{"variant": ..., "resize": [w, h] | null, "detections":
{filename: [[x0, y0, x1, y1, conf], ...]}}``; the JAX package's CLI and
this one write and read the same files.

CLI::

    python -m infercam_onnx_tpu_torch.eval.goldens make --dir PICS \
        --out g.json [--device cuda|cpu]
    python -m infercam_onnx_tpu_torch.eval.goldens check --dir PICS \
        --goldens g.json [--device cuda|cpu]

``make`` runs the detector over the JPEGs of ``--dir`` and stores its
detections; ``check`` runs it again and applies the gate against the
stored goldens, prints the report as one JSON line and exits 1 when the
gate fails. Without ``--weights`` the detector takes its weights chain
(the converted cache, the cached or downloaded ONNX, then random weights
from ``--seed``), as the JAX CLI's does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from infercam_onnx_tpu_torch import codec
from infercam_onnx_tpu_torch.eval.parity import fidelity_gate, parity_report


def load_directory_frames(directory: str,
                          resize: tuple[int, int] | None = None
                          ) -> dict[str, np.ndarray]:
    """filename -> decoded [H, W, 3] uint8 frame for every JPEG in dir;
    ``resize=(w, h)`` applies a PIL-bilinear resize after decode, so one
    program shape serves the whole directory."""
    out: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(directory)):
        if not name.lower().endswith((".jpg", ".jpeg")):
            continue
        with open(os.path.join(directory, name), "rb") as f:
            frame = codec.decode_rgb(f.read())
        if resize is not None:
            from PIL import Image

            frame = np.asarray(Image.fromarray(frame).resize(
                resize, Image.BILINEAR))
        out[name] = frame
    return out


def detect_directory(detector, directory: str,
                     resize: tuple[int, int] | None = None
                     ) -> dict[str, list]:
    """filename -> [[x0,y0,x1,y1,conf], ...] for every JPEG in dir."""
    out: dict[str, list] = {}
    for name, frame in load_directory_frames(directory, resize).items():
        out[name] = [[*map(float, bbox), float(conf)]
                     for bbox, conf in detector.detect(frame)]
    return out


def load_goldens(path: str) -> dict[str, list]:
    """The ``detections`` table of a goldens fixture."""
    with open(path) as f:
        return json.load(f)["detections"]


def as_detection_sets(table: dict[str, list], names: list[str]):
    """A detections table as one [(bbox, conf), ...] list per name (empty
    for a name the table lacks)."""
    return [[(np.asarray(row[:4], np.float32), row[4])
             for row in table.get(n, [])] for n in names]


def check_against_goldens(detector, directory: str, goldens_path: str, *,
                          min_parity: float = 0.95,
                          resize: tuple[int, int] | None = None) -> dict:
    """Run ``detector`` over the JPEGs in ``directory`` and gate the result
    against the fixture; ``resize`` wins over the fixture's own.
    ``result["passed"]`` is the verdict."""
    with open(goldens_path) as f:
        meta = json.load(f)
    if resize is None and meta.get("resize"):
        resize = tuple(meta["resize"])
    got_table = detect_directory(detector, directory, resize=resize)
    want_table = meta["detections"]
    names = sorted(set(got_table) | set(want_table))
    report = parity_report(as_detection_sets(got_table, names),
                           as_detection_sets(want_table, names))
    result = report.as_dict()
    result["passed"] = fidelity_gate(report, min_parity)
    result["min_parity"] = min_parity
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Make or check golden detection fixtures with the "
                    "PyTorch port.")
    ap.add_argument("command", choices=["make", "check"])
    ap.add_argument("--dir", required=True, help="directory of JPEGs")
    ap.add_argument("--out", help="goldens file to write (make)")
    ap.add_argument("--goldens", dest="goldens",
                    help="goldens file to check against")
    ap.add_argument("--variant", default="RFB-640",
                    choices=["RFB-320", "RFB-640", "slim-320", "slim-640"])
    ap.add_argument("--min-parity", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resize", default=None,
                    help="WxH: PIL-bilinear resize after decode (pins "
                         "one program shape; recorded in the fixture)")
    ap.add_argument("--weights", default=None,
                    help=".npz weights (upstream names or the checkpoint "
                         "layout) instead of the cache/download/random "
                         "chain")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--top-k", type=int, default=512)
    ap.add_argument("--max-detections", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector

    detector = Detector(
        DetectorConfig(variant=args.variant,
                       compute_dtype=args.compute_dtype,
                       top_k=args.top_k,
                       max_detections=args.max_detections),
        weights=args.weights, rng=args.seed, device=args.device)

    resize = None
    if args.resize:
        w, h = args.resize.lower().split("x")
        resize = (int(w), int(h))

    if args.command == "make":
        if not args.out:
            ap.error("make requires --out")
        table = detect_directory(detector, args.dir, resize=resize)
        with open(args.out, "w") as f:
            json.dump({"variant": args.variant,
                       "resize": resize,
                       "detections": table}, f, indent=1)
        total = sum(len(v) for v in table.values())
        print(f"wrote {len(table)} images, {total} detections "
              f"to {args.out}")
        return 0

    if not args.goldens:
        ap.error("check requires --goldens")
    result = check_against_goldens(detector, args.dir, args.goldens,
                                   min_parity=args.min_parity,
                                   resize=resize)
    print(json.dumps(result))
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
