"""Inference server CLI (the port of ``infercam_onnx_tpu/serve.py``).

Usage::

    python -m infercam_onnx_tpu_torch.serve \
        [--device cuda|cpu] [--weights model.npz] \
        [--server-address 127.0.0.1:3000] [--socket-address 127.0.0.1:3001] \
        [--preset reference|throughput|lossless|latency] \
        [--variant RFB-320|RFB-640|slim-320|slim-640] \
        [--min-confidence 0.5] [--max-iou 0.5] [--top-k 256] \
        [--max-detections 64] [--max-batch 16] [--batch-window-ms 4] \
        [--queue-capacity 10] [--no-coalesce] \
        [--warmup 640x480,1280x720] [--warmup-sync] [--decode-scale 1] \
        [--decode-mode pixels|ycbcr|coefficients] [--annotate device|host] \
        [--annotate-splice-blocks 768] [--assume-frame-dims 1280x720] \
        [--tile-min-pixels N] [--tile-grid 2x2] \
        [--tiled-upload auto|rows|stacked] \
        [--link-adaptive on|off] [--link-healthy-mbps 250] \
        [--link-probe-period 0] [--link-annotate-floor-mbps 10] \
        [--link-tiled-crossover-mbps 40] [--link-tiled-ab on|off] \
        [--link-tiled-ab-tie-pct 10] \
        [--max-rss-mb N] [--profile-dir DIR] \
        [--data-parallel auto|on|off] \
        [--distributed HOST:PORT,num_processes=N,process_id=I] \
        [--lockstep-address HOST:PORT] [--compute-dtype bfloat16|float32] \
        [--onnx model.onnx [--runtime native|graph]]

The flags are the JAX server's for the ported paths: every decode mode
(pixels, ycbcr, coefficients), both annotate modes (device by default,
host), tiled high-resolution detection, the link probe, data-parallel
replicas over this host's cards and a lockstep cluster of several
processes (`parallel.lockstep`; ``cluster_launch.py`` starts one); the
presets are the JAX server's. ``--onnx`` loads an UltraFace ONNX export
through the structural converter; with ``--runtime graph`` the server runs
the graph itself (`models.onnx_exec.GraphDetector`, float32; no tiling and
no lockstep, as in the JAX server).
``--device`` picks the device (``cuda`` unless asked otherwise); without
``--weights`` or ``--onnx`` the detector takes its weights chain (the
converted cache, the cached or downloaded ONNX, then seeded random
weights), as the JAX server's does; ``--compute-dtype`` is the native conv trunk's (the JAX server's
native runtime runs bfloat16). Port 0 in an address binds a free port.
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import logging
import os
import signal
import sys
import traceback

# Named flag bundles (an explicitly passed flag wins over the preset),
# as in the JAX server.
PRESETS: dict[str, dict] = {
    "reference": {},
    "throughput": dict(decode_mode="ycbcr", decode_scale=2,
                       queue_capacity=48, max_batch=16,
                       batch_window_ms=6.0, warmup_async=True,
                       warmup="640x480"),
    "lossless": dict(decode_mode="ycbcr", decode_scale=2,
                     queue_capacity=96, max_batch=32,
                     batch_window_ms=15.0, no_coalesce=True,
                     warmup_async=True, warmup="640x480"),
    "latency": dict(decode_mode="ycbcr", decode_scale=1,
                    queue_capacity=4, max_batch=2,
                    batch_window_ms=0.0, warmup="640x480"),
}


def bucket_ladder(max_batch: int) -> list[int]:
    """Doubling batch-size ladder capped at ``max_batch`` (a cap that is
    not a power of two never dispatches a larger padded batch)."""
    buckets = [1]
    while buckets[-1] < max_batch:
        buckets.append(min(buckets[-1] * 2, max_batch))
    return buckets


def _dims(spec: str) -> tuple[int, int]:
    """"WxH" -> (w, h)."""
    w, h = spec.lower().split("x")
    return int(w), int(h)


def main(argv: list[str] | None = None) -> int:
    # allow_abbrev=False: presets find the explicitly passed flags by
    # name, which an abbreviation would evade
    ap = argparse.ArgumentParser(
        description="Serve face detection on the PyTorch port.",
        allow_abbrev=False)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--weights", default=None,
                    help=".npz weights: upstream names or the JAX "
                         "package's checkpoint layout")
    ap.add_argument("--server-address", default="127.0.0.1:3000",
                    help="HTTP address (default %(default)s)")
    ap.add_argument("--socket-address", default="127.0.0.1:3001",
                    help="TCP ingest address (default %(default)s)")
    ap.add_argument("--variant", default="RFB-320",
                    choices=["RFB-320", "RFB-640", "slim-320", "slim-640"])
    ap.add_argument("--min-confidence", type=float, default=0.5)
    ap.add_argument("--max-iou", type=float, default=0.5)
    ap.add_argument("--top-k", type=int, default=256)
    ap.add_argument("--max-detections", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=4.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--queue-capacity", type=int, default=10,
                    help="bounded infer queue; frames drop when it is full "
                         "(the reference's cap of 10). Raise it to at least "
                         "--max-batch for full batches under load")
    ap.add_argument("--max-rss-mb", type=int, default=0,
                    help="re-exec the server when its RSS exceeds this "
                         "many MiB (0 = off); senders reconnect")
    ap.add_argument("--rss-check-period", type=float, default=10.0,
                    help="seconds between RSS watchdog checks")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="batch every queued frame instead of the newest "
                         "per stream")
    ap.add_argument("--warmup", default="",
                    help="comma-separated WxH resolutions to warm up "
                         "before traffic, e.g. 640x480,1280x720")
    ap.add_argument("--warmup-async", dest="warmup_async",
                    action="store_true", default=True,
                    help="open the listeners at once and warm up on the "
                         "device thread meanwhile (the default)")
    ap.add_argument("--warmup-sync", dest="warmup_async",
                    action="store_false",
                    help="open the listeners only after the warm-up")
    ap.add_argument("--decode-mode", default="pixels",
                    choices=["pixels", "coefficients", "ycbcr"],
                    help="pixels: host RGB decode; ycbcr: host decode to "
                         "packed YCbCr planes, chroma upsample and colour "
                         "on the device; coefficients: host entropy "
                         "decode only, the IDCT on the device too")
    ap.add_argument("--decode-scale", type=int, default=1,
                    choices=[1, 2, 4, 8],
                    help="decode incoming JPEGs at 1/N resolution "
                         "(annotated output is then scaled too)")
    ap.add_argument("--annotate", default="device",
                    choices=["device", "host"],
                    help="device: /face_stream overlays, FDCT and "
                         "quantization on the device, the host only "
                         "entropy-codes (in coefficients mode the splice "
                         "transcode: only the blocks the overlay touched "
                         "come back, the rest stays bit-exact); host: PIL "
                         "draw and a full JPEG encode on the host")
    ap.add_argument("--annotate-splice-blocks", type=int, default=768,
                    help="splice transcode: per-frame budget of "
                         "overlay-touched 8x8 blocks read back; a frame "
                         "over it is annotated on the host")
    ap.add_argument("--assume-frame-dims", default=None,
                    help="scale drawn boxes by WxH instead of the decoded "
                         "frame's size (the reference hard-codes 1280x720)")
    ap.add_argument("--tile-min-pixels", type=int, default=0,
                    help="frames with at least this many pixels (after "
                         "decode) run through an overlapping tile grid "
                         "with a cross-tile NMS merge (0: off; e.g. "
                         "921600 for 1280x720 and up)")
    ap.add_argument("--tile-grid", default="2x2",
                    help="tile grid CxR for those frames")
    ap.add_argument("--tiled-upload", default="auto",
                    choices=["auto", "rows", "stacked"],
                    help="upload of tiled packed-plane batches: stacked = "
                         "one copy of the batch, rows = one copy a frame "
                         "stacked on the device, auto = by the link probe")
    ap.add_argument("--link-adaptive", default="on", choices=["on", "off"],
                    help="probe the host->device rate after start-up (and "
                         "every --link-probe-period s) and re-select the "
                         "decode mode, tiled upload and annotate mode by "
                         "it; /stats 'link' shows the decisions. off = "
                         "serve exactly the configured paths")
    ap.add_argument("--link-healthy-mbps", type=float, default=250.0,
                    help="MB/s at or above which the link is healthy; "
                         "below it coefficients mode serves through the "
                         "packed YCbCr planes")
    ap.add_argument("--link-probe-period", type=float, default=0.0,
                    help="re-probe the link every N seconds (0: once)")
    ap.add_argument("--link-annotate-floor-mbps", type=float, default=10.0,
                    help="MB/s below which device annotation gives way to "
                         "the host draw")
    ap.add_argument("--link-tiled-crossover-mbps", type=float, default=40.0,
                    help="with --link-tiled-ab off, links below this many "
                         "MB/s take the rows route under --tiled-upload "
                         "auto")
    ap.add_argument("--link-tiled-ab", default="on", choices=["on", "off"],
                    help="time both tiled upload routes on each probe and "
                         "let --tiled-upload auto take the faster")
    ap.add_argument("--link-tiled-ab-tie-pct", type=float, default=10.0,
                    help="A/B gaps below this percent pick stacked")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the run here")
    ap.add_argument("--data-parallel", default="auto",
                    choices=["auto", "on", "off"],
                    help="split stream batches over this host's cards "
                         "(auto: when the cluster has >1 device; on: "
                         "require that)")
    ap.add_argument("--distributed", default=None,
                    help="a cluster of several processes: host:port,"
                         "num_processes=N,process_id=I (a torch.distributed "
                         "gloo group)")
    ap.add_argument("--lockstep-address", default=None,
                    help="host:port of the lockstep dispatch coordinator "
                         "(process 0 runs it); every member of a "
                         "--distributed cluster serves with it")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="dtype of the conv trunk")
    ap.add_argument("--onnx", default=None,
                    help="explicit ONNX file to load weights from")
    ap.add_argument("--runtime", default="native",
                    choices=["native", "graph"],
                    help="graph: run the ONNX graph itself through the "
                         "graph executor (requires --onnx)")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="named flag bundle (explicit flags override)")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)

    if args.preset:
        tokens = argv if argv is not None else sys.argv[1:]
        # flag spellings -> argparse dests, so --warmup-sync counts as
        # setting warmup_async
        flag_dest = {opt[2:].replace("-", "_"): action.dest
                     for action in ap._actions
                     for opt in action.option_strings
                     if opt.startswith("--")}
        passed = {flag_dest.get(name, name) for name in
                  (t.split("=", 1)[0][2:].replace("-", "_")
                   for t in tokens if t.startswith("--"))}
        for key, value in PRESETS[args.preset].items():
            if key not in passed:
                setattr(args, key, value)

    if args.lockstep_address:
        if not args.distributed:
            ap.error("--lockstep-address requires --distributed")
        if args.data_parallel == "off":
            ap.error("--lockstep-address requires data-parallel serving")
        if args.tile_min_pixels:
            ap.error("--lockstep-address does not support tiling")
        if args.runtime != "native":
            ap.error("--lockstep-address requires --runtime native")
        # --max-rss-mb is allowed: a breach exits the member with
        # RSS_RECYCLE_EXIT_CODE for the cluster supervisor to re-form the
        # cluster (serving/app.py)

    if args.runtime == "graph":
        if not args.onnx:
            ap.error("--runtime graph requires --onnx")
        if args.tile_min_pixels:
            ap.error("--runtime graph does not support tiling")

    from infercam_onnx_tpu_torch.config import (DetectorConfig, EngineConfig,
                                                ServerConfig)
    from infercam_onnx_tpu_torch.serving.app import serve_forever
    from infercam_onnx_tpu_torch.utils.profiling import device_trace

    try:
        engine_config = EngineConfig(
            batch_buckets=tuple(bucket_ladder(args.max_batch)),
            batch_window_ms=args.batch_window_ms,
            queue_capacity=args.queue_capacity,
            coalesce_streams=not args.no_coalesce,
            decode_scale=args.decode_scale,
            decode_mode=args.decode_mode,
            annotate_mode=args.annotate,
            annotate_splice_blocks=args.annotate_splice_blocks,
            link_adaptive=args.link_adaptive == "on",
            link_healthy_h2d_mbps=args.link_healthy_mbps,
            link_probe_period_s=args.link_probe_period,
            link_annotate_floor_mbps=args.link_annotate_floor_mbps,
            link_tiled_rows_below_mbps=args.link_tiled_crossover_mbps,
            link_tiled_ab_probe=args.link_tiled_ab == "on",
            link_tiled_ab_tie_pct=args.link_tiled_ab_tie_pct,
            tiled_upload=args.tiled_upload,
            tile_min_pixels=args.tile_min_pixels,
            tile_grid=_dims(args.tile_grid))
    except ValueError as e:
        where = f" (preset {args.preset})" if args.preset else ""
        ap.error(f"{e}{where}")

    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s.%(msecs)03d %(levelname)s %(name)s: "
               "%(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S")
    faulthandler.register(signal.SIGUSR1)  # SIGUSR1 dumps thread stacks

    warmup = []
    for spec in filter(None, args.warmup.split(",")):
        w, h = _dims(spec)
        warmup.append((h, w))

    detector_config = DetectorConfig(
        variant=args.variant,
        min_confidence=args.min_confidence,
        max_iou=args.max_iou,
        top_k=args.top_k,
        max_detections=args.max_detections,
        compute_dtype=("float32" if args.runtime == "graph"
                       else args.compute_dtype))
    exit_code = 0
    try:
        if args.distributed:
            from infercam_onnx_tpu_torch.parallel.multihost import initialize

            initialize(args.distributed)
        detector = None
        if args.runtime == "graph":
            from infercam_onnx_tpu_torch.models.onnx_exec import GraphDetector

            detector = GraphDetector(args.onnx, detector_config,
                                     device=args.device)
        elif args.onnx:
            from infercam_onnx_tpu_torch.detector import Detector
            from infercam_onnx_tpu_torch.models.convert import params_from_onnx

            detector = Detector(detector_config,
                                params=params_from_onnx(args.onnx),
                                device=args.device)
        with device_trace(args.profile_dir):
            asyncio.run(serve_forever(
                server_config=ServerConfig(
                    http_address=args.server_address,
                    socket_address=args.socket_address,
                    assume_frame_dims=(_dims(args.assume_frame_dims)
                                       if args.assume_frame_dims else None),
                    max_rss_mb=args.max_rss_mb,
                    rss_check_period_s=args.rss_check_period),
                detector_config=detector_config,
                detector=detector,
                engine_config=engine_config,
                warmup_resolutions=warmup or None,
                warmup_async=args.warmup_async,
                device=args.device,
                weights=args.weights,
                data_parallel=args.data_parallel,
                lockstep_address=args.lockstep_address))
    except KeyboardInterrupt:
        pass
    except Exception:
        if not args.distributed:
            raise
        # a crash (a bind failure, a refused lockstep peer, a failed
        # group) must reach the supervisor as a non-zero status
        traceback.print_exc()
        exit_code = 1
    finally:
        if args.distributed:
            # after the graceful close (listeners down, the session left),
            # exit hard with the tracked status: the process group's
            # threads would otherwise hold the interpreter's teardown, and
            # a member that stops alone has no peer to tear it down with
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(exit_code)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
