"""Single-image detection CLI (the port's ``infercam_onnx_tpu/detect.py``).

Usage::

    python -m infercam_onnx_tpu_torch.detect photo.jpg [-o out.jpg] \
        [--variant RFB-640] [--weights model.npz] [--device cuda|cpu] \
        [--onnx model.onnx [--runtime native|graph]]

Decodes the JPEG on the host, runs preprocess + UltraFace + filter + NMS
on the device, prints the detections as one JSON line and, with ``-o``,
writes the annotated JPEG. ``--weights`` reads an .npz in either layout
`models.checkpoint.load_params` knows; ``--onnx`` reads an UltraFace ONNX
export through the structural converter (`models.convert.params_from_onnx`),
or with ``--runtime graph`` runs the graph itself in float32
(`models.onnx_exec.GraphDetector`). Without either the detector takes
the JAX package's weights chain: the converted .npz cache, then the
cached or downloaded ONNX file (both under
``$XDG_CACHE_HOME/infercam_onnx_tpu``), then deterministic random
weights from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Detect faces in one JPEG with the PyTorch port.")
    ap.add_argument("image", help="input JPEG path")
    ap.add_argument("-o", "--output", help="annotated output JPEG path")
    ap.add_argument("--variant", default="RFB-320",
                    choices=["RFB-320", "RFB-640", "slim-320", "slim-640"])
    ap.add_argument("--min-confidence", type=float, default=0.5)
    ap.add_argument("--max-iou", type=float, default=0.5)
    ap.add_argument("--top-k", type=int, default=256,
                    help="candidates entering NMS")
    ap.add_argument("--max-detections", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights the weights chain "
                         "ends in")
    ap.add_argument("--weights", default=None,
                    help=".npz weights: upstream names or the JAX "
                         "package's checkpoint layout")
    ap.add_argument("--onnx", default=None,
                    help="explicit ONNX file to load weights from")
    ap.add_argument("--runtime", default="native",
                    choices=["native", "graph"],
                    help="graph: run the ONNX graph itself through the "
                         "graph executor (requires --onnx)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.runtime == "graph" and not args.onnx:
        ap.error("--runtime graph requires --onnx")

    from infercam_onnx_tpu_torch import codec
    from infercam_onnx_tpu_torch.config import DetectorConfig
    from infercam_onnx_tpu_torch.detector import Detector
    from infercam_onnx_tpu_torch.draw import draw_detections

    with open(args.image, "rb") as f:
        frame = codec.decode_rgb(f.read())
    config = DetectorConfig(
        variant=args.variant, min_confidence=args.min_confidence,
        max_iou=args.max_iou, top_k=args.top_k,
        max_detections=args.max_detections,
        compute_dtype=("float32" if args.runtime == "graph"
                       else DetectorConfig.compute_dtype))
    if args.runtime == "graph":
        from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

        det = GraphDetector(args.onnx, config, device=args.device)
    elif args.onnx:
        from infercam_onnx_tpu_torch.models.convert import params_from_onnx

        det = Detector(config, params=params_from_onnx(args.onnx),
                       device=args.device)
    else:
        det = Detector(config, weights=args.weights, rng=args.seed,
                       device=args.device)
    detections = det.detect(frame)

    print(json.dumps({
        "image": args.image,
        "device": str(det.device),
        "faces": len(detections),
        "detections": [
            {"bbox": [float(v) for v in bbox], "confidence": conf}
            for bbox, conf in detections
        ],
    }))
    if args.output:
        annotated = draw_detections(frame, detections)
        with open(args.output, "wb") as f:
            f.write(codec.encode_rgb(annotated))
    return 0


if __name__ == "__main__":
    sys.exit(main())
