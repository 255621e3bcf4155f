"""The readings the limits of ``correct`` are set from, for one cell, in
one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,c \\
        [--control-seeds a,b,c] [--faults stale,chroma_swapped] \\
        [--fault-seeds a,b] [--seconds 5]

For each seed of ``--seeds``: a short window of the cell's own traffic
through the port's server (the same set-up as a run) and the numbers
``correct`` compares, for every record that answers a frame sent in the
window. For each seed of ``--control-seeds`` besides, the two controls
in the program's place, each the reference in the precision below the
configuration's (``tf32``: the resize's operands rounded to TF32, below
its IEEE float32; ``fp8``: the trunk's convolutions in float8 e4m3,
below its bfloat16), their detections for every frame the program's
records answered, against the same reference. For each fault of
``--faults`` and seed of ``--fault-seeds``: the run with that fault
planted in the timed path (`harness.faults`). One JSON line a reading.
The lower reading of a number is the largest the program gives over the
seeds, the upper the smallest a control gives; a limit lies between.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()

    import torch

    from harness import cell, compare
    from harness.faults import FAULTS
    from harness.spec import Spec

    spec = Spec()
    entry = spec.workload(args.workload)
    cfg = spec.config(entry["config"])
    traffic = spec.traffic(entry["traffic"])
    path = spec.traffic_path(entry["traffic"])
    device = torch.device("cuda", 0)
    limits = spec.limits(args.workload)["limits"]

    def window(seed, fault=None):
        return asyncio.run(cell.run_window(
            cfg, traffic, path, seed, args.seconds, device=device,
            t_process=time.monotonic(), program_fault=fault))

    def emit(**line):
        print(json.dumps({"workload": args.workload, **line}), flush=True)

    control_seeds = set(_seeds(args.control_seeds))
    for seed in sorted(set(_seeds(args.seeds)) | control_seeds):
        run = window(seed)
        refs = cell.references(cfg, traffic, seed, run.work["params"],
                               device)
        judged, unmatched = cell.pair(run, refs)
        program = compare.compare(judged, refs, cfg)
        program["unmatched"] = float(unmatched)
        emit(seed=seed, side="program", setup_s=run.setup_s, **program)
        if seed in control_seeds:
            # one record a frame the program's records answered
            frames = sorted({(s, d, size) for s, d, _, size in judged})
            for control in ("tf32", "bf16", "fp8"):
                ctl = cell.references(cfg, traffic, seed,
                                      run.work["params"], device,
                                      control=control)
                records = [(s, d, cell.as_record(ctl[s][d][2], size), size)
                           for s, d, size in frames]
                emit(seed=seed, side=control,
                     **compare.compare(records, refs, cfg))
        del run
    for name in [f for f in args.faults.split(",") if f]:
        for seed in _seeds(args.fault_seeds):
            run = window(seed, FAULTS[name])
            checks = cell.judge(run, seed, device)
            emit(seed=seed, side=f"fault:{name}",
                 correct=bool(checks["records"]) and all(
                     checks[k] <= v for k, v in limits.items()),
                 **checks)
            del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
