"""On-chip microbenchmark: the device time of each stage of the detect
programs (the counterpart of ``tools/microbench.py``).

    python -m infercam_onnx_tpu_torch.microbench [--batches 1,16,64]
        [--iters 100] [--variant RFB-320] [--device cuda|cpu]

For each batch size it runs every stage ``--iters`` times back to back on
a device-resident input, perturbed by the call's index, and reports the
device busy time per call (`bench.device_time`: the sum of the kernel
durations torch.profiler records; the JAX tool loops each program inside
one executable). The host's dispatch cost is what the JAX tool's loop
hides, and what this reading leaves out. Stages, on 640x480 frames:

- ``preprocess``: the two resize matmuls, the u8 round and the normalize;
- ``preprocess+cnn``: and the UltraFace trunk (bfloat16);
- ``full``: and filter + the NMS kernel (`detector.detect_program`);
- ``annotated``: detect + overlay + FDCT/quantize from packed YCbCr planes
  (`detector.detect_annotate_from_ycbcr`);
- ``splice``: the coefficient splice transcode from 12-bit packed blocks
  (`detector.detect_annotate_splice`, k = 768);
- ``tiled_1080p``: 2x2 tiled detection of 1920x1080 frames
  (`parallel.tiling.TiledDetector`), batches up to 4.

Prints one JSON line per batch size with the JAX tool's keys (``batch``,
``iters``, ``device``, ``<stage>_ms``, ``fps_on_chip``) plus
``time_source`` ("cupti" on a GPU, "host_clock" with ``--device cpu``),
``power_limit`` and ``nms_launches`` (the NMS kernel's launches in the
line's stages). The weights are `bench.random_params`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from infercam_onnx_tpu_torch import bench, codec
from infercam_onnx_tpu_torch.config import resolve_device
from infercam_onnx_tpu_torch.detector import (detect_annotate_from_ycbcr,
                                              detect_annotate_splice,
                                              detect_program,
                                              pack_coefficient_batch)
from infercam_onnx_tpu_torch.native import jpeg as native_jpeg
from infercam_onnx_tpu_torch.ops import nms
from infercam_onnx_tpu_torch.ops.jpeg_device import read_coefficient_batch
from infercam_onnx_tpu_torch.ops.preprocess import preprocess_images
from infercam_onnx_tpu_torch.parallel.tiling import TiledDetector

SPLICE_K = 768  # EngineConfig.annotate_splice_blocks' default
TILED_MAX_BATCH = 4


def stage_programs(det, batch: int) -> dict:
    """Stage name -> ``fn(i)`` running it once on resident inputs
    perturbed by ``i``."""
    dev, model, priors = det.device, det.model, det.priors
    h, w = det.height * 2, det.width * 2  # 640x480-style input
    r_h, r_w = det.preprocessor.matrices(w, h)
    thresholds = det._thresholds()
    images = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=dev)
    probe = codec.encode_rgb(np.zeros((h, w, 3), np.uint8), 90, "420")

    def preprocess(i):
        return preprocess_images(images + i % 256, r_h, r_w)

    def cnn(i):
        return model(preprocess(i), priors)

    def full(i):
        return detect_program(model, priors, images + i % 256, r_h, r_w,
                              pack_output=True, **thresholds)

    packed, geom = native_jpeg.load().decode_ycbcr_batch([probe] * batch)
    packed = torch.from_numpy(packed).to(dev)
    quant = torch.from_numpy(native_jpeg.quant_tables_cached(95).astype(
        np.float32)).to(dev)
    ra_h, ra_w = det.preprocessor.matrices(geom["width"], geom["height"])

    def annotated(i):
        return detect_annotate_from_ycbcr(
            model, priors, packed + i % 256, ra_h, ra_w, quant,
            width=geom["width"], height=geom["height"], y_pw=geom["y_pw"],
            y_ph=geom["y_ph"], c_pw=geom["c_pw"], c_ph=geom["c_ph"],
            sampling=tuple(geom["sampling"]), disp_dims=None, **thresholds)

    y, cb, cr, squant, wh, samp = read_coefficient_batch([probe] * batch)
    packed12, squant, ((y_bh, y_bw), (c_bh, c_bw)) = pack_coefficient_batch(
        y, cb, cr, squant)
    packed12 = torch.from_numpy(packed12).to(dev)
    squant = torch.from_numpy(squant.astype(np.int32)).to(dev)
    rs_h, rs_w = det.preprocessor.matrices(*wh)

    def splice(i):
        return detect_annotate_splice(
            model, priors, packed12 + i % 256, squant, rs_h, rs_w,
            width=wh[0], height=wh[1], y_bw=y_bw, y_bh=y_bh, c_bw=c_bw,
            c_bh=c_bh, sampling=tuple(samp), k=SPLICE_K, disp_dims=None,
            **thresholds)

    stages = {"preprocess": preprocess, "preprocess+cnn": cnn, "full": full,
              "annotated": annotated, "splice": splice}
    if batch <= TILED_MAX_BATCH:  # 1080p batches past 4 are not served
        tiled = TiledDetector(det, (1920, 1080), grid=(2, 2))
        hd = torch.zeros((batch, 1080, 1920, 3), dtype=torch.uint8,
                         device=dev)

        def tiled_1080p(i):
            return tiled.run_device(hd + i % 256, pack_output=True)

        stages["tiled_1080p"] = tiled_1080p
    return stages


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Device time per stage of the detect programs; one "
                    "JSON line per batch size.")
    ap.add_argument("--batches", default="1,16,64")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--variant", default="RFB-320")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    det = bench.make_detector(dev, args.variant)
    limit = bench.power_limit() if dev.type == "cuda" else None
    for batch in (int(b) for b in args.batches.split(",")):
        row = {"batch": batch, "iters": args.iters,
               "device": bench.device_name(dev), "power_limit": limit}
        launches = nms.kernel.launches
        for stage, fn in stage_programs(det, batch).items():
            t = bench.device_time(fn, args.iters, dev)
            row[f"{stage}_ms"] = round(t["busy_ms"], 4)
            row["time_source"] = t["source"]
        row["fps_on_chip"] = round(batch / row["full_ms"] * 1e3, 1)
        row["nms_launches"] = nms.kernel.launches - launches
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
