"""Find a traffic mix's knee: the highest rate of frames the port's server
delivers under it, by a sweep over the number of streams.

    python3 benchmark/sweep.py --config rfb320 --traffic <mix> \\
        --streams 8,16,24,32 [--seconds 5] [--seed N]

One process; for each stream count, a fresh server and load generator
under the mix with that many streams, buckets doubling up to the stream
count and a queue of 2 s of the offered frames
(`harness.cell.run_window`, no reference check), a short window, and one
JSON line: offered and
delivered frames/s, the share shed, the mean batch, the sender's lag, the
e2e p50/p95 and the server's CPU time per frame delivered. A cell above
its knee is offered about 1.5 times the largest delivered rate; a cell
below it, a share of it.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args()

    import torch

    from harness import cell
    from harness.spec import Spec

    spec = Spec()
    cfg = json.loads((BENCH / "configs" / f"{args.config}.json").read_text())
    base = spec.traffic(args.traffic)
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        for n in map(int, args.streams.split(",")):
            # buckets doubling up to the stream count, a queue of 2 s of
            # the offered frames
            buckets = [1]
            while buckets[-1] < n:
                buckets.append(buckets[-1] * 2)
            traffic = dict(base, streams=n, batch_buckets=buckets,
                           queue_capacity=int(2 * n * base["fps_per_stream"]))
            path = pathlib.Path(tmp, f"sweep_{n}.json")
            path.write_text(json.dumps(traffic))
            run = asyncio.run(cell.run_window(
                cfg, traffic, path, args.seed, args.seconds, device=device,
                t_process=time.monotonic()))
            lat = run.latencies()
            received = run.received()
            batches = run.meter.get("batches", 0)
            print(json.dumps({
                "config": args.config, "traffic": args.traffic, "streams": n,
                "offered_fps": n * traffic["fps_per_stream"],
                "delivered_fps": sum(run.load["received"]) / args.seconds,
                "shed_pct": 100.0 * run.meter.get("dropped", 0)
                / max(received, 1),
                "mean_batch": run.meter.get("inferred_unique", 0)
                / max(batches, 1),
                "sender_lag_ms": run.load["lag_ms_mean"],
                "e2e_p50_ms": 1e3 * lat[len(lat) // 2] if lat else None,
                "e2e_p95_ms": 1e3 * lat[int(0.95 * len(lat))] if lat
                else None,
                "server_cpu_ms_per_frame": 1e3 * run.server_cpu_s
                / max(sum(run.load["received"]), 1),
                "setup_s": run.setup_s}), flush=True)
            del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
