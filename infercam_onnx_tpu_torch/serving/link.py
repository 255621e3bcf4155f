"""Host->device link probing and the transfer-path policy (the port of
``infercam_onnx_tpu/serving/link.py``).

The server probes the host->device copy rate after its warm-up, and on a
timer where ``link_probe_period_s`` says so, and re-selects every serving
choice that depends on it (`decide`):

- the decode mode: a degraded link moves "coefficients" (full-size int16
  blocks up) onto the packed-YCbCr path, about half the bytes;
- the tiled upload route: one stacked copy of a batch, or one copy a
  frame, stacked on the device; "auto" picks the one measured faster
  (`probe_tiled_route_ms`);
- the annotate mode: device annotation gives way to the host draw only on
  a collapse-grade link.

Each probe re-evaluates every configured choice, so a recovered link gets
its configured paths back. The worker exposes the decision table in
``/stats`` under ``link``.

The thresholds (`EngineConfig`: 250 MB/s healthy, the 40 MB/s tiled
crossover, the 10 MB/s annotate floor, the 10% tie band) were measured on
the JAX package's TPU host link; they are kept as the defaults and not
re-tuned here. The policy functions are the JAX package's, their ``why``
strings included.
"""

from __future__ import annotations

import logging
import time

import torch

from infercam_onnx_tpu_torch.config import resolve_device

log = logging.getLogger("infercam.link")


def _timed_copies(srcs: list[torch.Tensor], device: torch.device) -> float:
    """Seconds that one copy of each of ``srcs`` into a tensor of its own
    on ``device`` (allocated beforehand) takes, the copies issued back to
    back. On a CUDA device they are non-blocking copies on the calling
    thread's current stream, timed by two events on the device's clock, so
    work queued on the stream before them is not counted; on the CPU they
    are host copies timed by the host's clock."""
    dsts = [torch.empty(src.shape, dtype=src.dtype, device=device)
            for src in srcs]
    if device.type != "cuda":
        t0 = time.perf_counter()
        for dst, src in zip(dsts, srcs):
            dst.copy_(src)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        for dst, src in zip(dsts, srcs):
            dst.copy_(src, non_blocking=True)
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _host_bytes(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A zero uint8 host tensor, pinned when it goes to a CUDA device."""
    return torch.zeros(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def probe_h2d_mbps(size_mb: float = 4.0, trials: int = 3, *,
                   device: str | torch.device = "cuda") -> float:
    """Measured host->device rate in MB/s, the best of ``trials`` timed
    copies of a ``size_mb`` pinned host tensor (best of N, so one hiccup
    does not misclassify the link). On ``device="cpu"``, which the caller
    must ask for, it times host copies."""
    dev = resolve_device(device)
    src = _host_bytes((int(size_mb * 1024 * 1024),), dev)
    best = min(_timed_copies([src], dev) for _ in range(trials))
    return size_mb / best


def probe_tiled_route_ms(frames: int = 4, mb_per_frame: float = 0.78,
                         trials: int = 2, *,
                         device: str | torch.device = "cuda"
                         ) -> tuple[float, float]:
    """Both tiled upload routes timed as the worker issues them: "stacked"
    is one copy of a [frames, n] batch, "rows" is ``frames`` copies of one
    [n] row each, back to back, then one wait. Returns (stacked_ms,
    rows_ms) a batch, the best of ``trials`` each, the two interleaved so
    that drift mid-probe biases neither. The default geometry is a batch
    of 4 packed 4:2:0 frames of 1080p at decode scale 2 (960x540, 0.78
    MB each)."""
    dev = resolve_device(device)
    whole = _host_bytes((frames, int(mb_per_frame * 1024 * 1024)), dev)
    rows = list(whole)  # each row a contiguous block of its own
    stacked = rowwise = float("inf")
    for _ in range(max(1, trials)):
        stacked = min(stacked, _timed_copies([whole], dev))
        rowwise = min(rowwise, _timed_copies(rows, dev))
    return stacked * 1e3, rowwise * 1e3


def decide_decode_mode(configured_mode: str, h2d_mbps: float,
                       healthy_mbps: float) -> tuple[str, str]:
    """Effective decode mode for a measured link; returns (mode, why).

    Only the coefficients mode is re-routed: its uploads are full-res
    12-bit coefficient planes that cannot ride the scaled decode, and
    its annotate tail (the splice transcode) is the documented
    degraded-link collapse. "pixels" (the reference-parity default)
    and "ycbcr" are left exactly as configured.
    """
    if configured_mode != "coefficients":
        return configured_mode, "configured path kept"
    if h2d_mbps >= healthy_mbps:
        return configured_mode, (
            f"link healthy ({h2d_mbps:.0f} >= {healthy_mbps:.0f} MB/s)")
    return "ycbcr", (
        f"H2D degraded ({h2d_mbps:.0f} < {healthy_mbps:.0f} MB/s): "
        "full-res coefficient uploads would collapse; re-routed to "
        "packed-YCbCr transfers until a probe sees recovery")


def decide_tiled_route(configured: str, h2d_mbps: float,
                       rows_below_mbps: float,
                       ab_ms: tuple[float, float] | None = None,
                       tie_pct: float = 10.0) -> tuple[str, str]:
    """Upload route for tiled high-res packed-plane batches; returns
    (route, why) where route is "rows" or "stacked".

    "stacked" ships the whole batch in one copy; "rows" issues one copy
    a frame back to back and stacks on the device. With ``ab_ms``
    (stacked_ms, rows_ms) from `probe_tiled_route_ms`, "auto" picks the
    measured winner, except inside the ``tie_pct`` band, where it picks
    "stacked"; without one, the crossover threshold ``rows_below_mbps``
    decides. An explicit configuration always wins.
    """
    if configured in ("rows", "stacked"):
        return configured, "configured route kept"
    if ab_ms is not None:
        stacked_ms, rows_ms = ab_ms
        gap = abs(stacked_ms - rows_ms) / max(stacked_ms, rows_ms, 1e-9)
        if gap * 100.0 < tie_pct:
            return "stacked", (
                f"measured A/B within the {tie_pct:.0f}% tie band "
                f"(stacked {stacked_ms:.1f} vs rows {rows_ms:.1f} ms "
                "per batch — inside link noise): one large copy by "
                "default")
        if rows_ms < stacked_ms:
            return "rows", (
                f"measured A/B: rows {rows_ms:.1f} ms vs stacked "
                f"{stacked_ms:.1f} ms per batch — chunked per-frame "
                "async uploads win on this link state")
        return "stacked", (
            f"measured A/B: stacked {stacked_ms:.1f} ms vs rows "
            f"{rows_ms:.1f} ms per batch — one large copy wins on "
            "this link state")
    if h2d_mbps >= rows_below_mbps:
        return "stacked", (
            f"link at/above the measured crossover ({h2d_mbps:.0f} >= "
            f"{rows_below_mbps:.0f} MB/s): one large copy beats "
            "per-frame transfer overhead")
    return "rows", (
        f"H2D below the measured crossover ({h2d_mbps:.0f} < "
        f"{rows_below_mbps:.0f} MB/s): chunked per-frame async uploads "
        "amortize the fixed per-transfer cost")


def decide_annotate_mode(configured: str, h2d_mbps: float,
                         floor_mbps: float) -> tuple[str, str]:
    """Annotated-output rendering for a measured link; returns (mode,
    why) where mode is "device" or "host". Only a collapse-grade link,
    below ``floor_mbps``, moves device annotation to the host draw."""
    if configured != "device":
        return configured, "configured mode kept"
    if h2d_mbps >= floor_mbps:
        return "device", (
            f"device annotate kept ({h2d_mbps:.0f} >= floor "
            f"{floor_mbps:.0f} MB/s; measured faster than host down "
            "to ~38 MB/s)")
    return "host", (
        f"H2D collapsed ({h2d_mbps:.0f} < floor {floor_mbps:.0f} "
        "MB/s): coefficient readback would dominate; host draw until "
        "a probe sees recovery")


def decide(engine_config, h2d_mbps: float,
           tiled_ab_ms: tuple[float, float] | None = None) -> dict:
    """The decision table of one probe: each transfer-sensitive serving
    choice as {configured, effective, why} (what ``/stats`` shows under
    ``link.decisions``). ``tiled_ab_ms`` is `probe_tiled_route_ms`'s
    (stacked_ms, rows_ms), or None for the threshold."""
    healthy = engine_config.link_healthy_h2d_mbps
    mode, mode_why = decide_decode_mode(
        engine_config.decode_mode, h2d_mbps, healthy)
    route, route_why = decide_tiled_route(
        engine_config.tiled_upload, h2d_mbps,
        engine_config.link_tiled_rows_below_mbps, ab_ms=tiled_ab_ms,
        tie_pct=engine_config.link_tiled_ab_tie_pct)
    annot, annot_why = decide_annotate_mode(
        engine_config.annotate_mode, h2d_mbps,
        engine_config.link_annotate_floor_mbps)
    return {
        "decode_mode": {"configured": engine_config.decode_mode,
                        "effective": mode, "why": mode_why},
        "tiled_upload": {"configured": engine_config.tiled_upload,
                         "effective": route, "why": route_why},
        "annotate_mode": {"configured": engine_config.annotate_mode,
                          "effective": annot, "why": annot_why},
    }
