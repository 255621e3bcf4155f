"""The benchmark of ``infercam_onnx_tpu_torch``, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: the
port's server (`serving.app.start_server`) in this process, its cameras
and viewers in a child process, a window of ``--seconds``, then the
check of every record that answers a frame sent in the window against
the plain reference (``reference/``). Prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted`` (frames the server received in the
window), ``failed`` (of them, frames not published), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``, then ``checks``, each compared
number with its limit; the checks are also the last lines of standard
error.

Exits 3 without a result where no CUDA card is present (or fewer than the
cell asks for), and 4 where JAX, Flax or the JAX package was imported.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = {"jax", "jaxlib", "flax", "infercam_onnx_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & FORBIDDEN)


def evaluate(run, checks: dict, limit: dict, spec, workload: str,
             traced: bool) -> dict:
    """The result line's object."""
    from harness.spec import reader

    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics(workload, section):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {name: {"value": checks[name], "limit": lim}
                for name, lim in limit["limits"].items()}
    correct = (checks["records"] > 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    received = run.received()
    published = len(run.latencies())
    out = {"correct": correct, "attempted": received,
           "failed": max(0, received - published), "metrics": metrics,
           "device": dict(run.device)}
    if traced and run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {**compared,
                     "records": {"value": checks["records"], "limit": 1,
                                 "holds": "at least"}}
    return out


def host_readings(run) -> str:
    """What the host's clock reads of the window beside the metrics, for
    the record (PERF.md section 7)."""
    delivered = sum(run.load["received"])
    received = run.received()
    return (
        f"frames received by the server {received}, delivered to viewers "
        f"{delivered} ({delivered / (run.t1 - run.t0):.1f} frames/s), shed "
        f"{100.0 * run.meter.get('dropped', 0) / max(received, 1):.2f}%, "
        f"sender lag {run.load['lag_ms_mean']:.3f} ms (max "
        f"{run.load['lag_ms_max']:.3f}), sender errors "
        f"{len(run.load['errors'])}, server CPU {run.server_cpu_s:.3f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness.spec import Spec

    spec = Spec()
    cell = spec.workload(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s), this machine has {have}", file=sys.stderr)
        return 3
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


def run_cell(spec, workload: str, seed: int, seconds: float, traced: bool,
             device, program_fault=None) -> dict | None:
    """One run: the result object, or None where a forbidden module was
    loaded."""
    import torch

    from harness import cell as cell_mod
    from harness import compare, work

    cell = spec.workload(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    run = asyncio.run(cell_mod.run_window(
        cfg, traffic, spec.traffic_path(cell["traffic"]), seed, seconds,
        device=device, t_process=T_PROCESS, traced=traced,
        program_fault=program_fault))
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return None
    checks = cell_mod.judge(run, seed, device)
    if traced and run.trace is not None:
        run.work.update(cell_mod.work_counts(run, device))
        run.trace["frames"] = len(run.spans_in(
            "e2e", start=run.trace["t0"], end=run.trace["t1"]))
        run.trace["peaks"] = work.peaks(torch.cuda.get_device_name(device))
    result = evaluate(run, checks, spec.limits(workload), spec, workload,
                      traced)
    print(f"[bench] {workload} seed {seed}: {host_readings(run)}; "
          f"{checks['records']} records judged, {checks['detections']} "
          f"detections, {checks['off_share']:.3f}% off by over "
          f"{compare.OFF}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return result


if __name__ == "__main__":
    sys.exit(main())
