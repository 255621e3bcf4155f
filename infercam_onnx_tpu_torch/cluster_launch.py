#!/usr/bin/env python3
"""Launcher and supervisor of an N-process lockstep serving cluster (the
port's copy of the JAX package's ``tools/cluster_launch.py``).

One command spawns N `infercam_onnx_tpu_torch.serve` processes joined in
one ``torch.distributed`` gloo group (localhost coordinator) and the
lockstep dispatch tier (`parallel.lockstep`), each with its own HTTP and
ingest ports::

    python -m infercam_onnx_tpu_torch.cluster_launch --hosts 2
    # host 0: http://127.0.0.1:3000  ingest 127.0.0.1:3001
    # host 1: http://127.0.0.1:3010  ingest 127.0.0.1:3011

Feed each "host" with its own sender and watch its own /face_stream.
Ctrl-C tears the cluster down. ``--device`` goes to every member (``cuda``
by default: the members share this machine's cards, one of them as
readily as several; ``cpu`` for a cluster without a card). On several
machines run one serve per machine with the same flags instead.

**Supervision.** The lockstep session is fail-stop by design: a process
cannot rejoin a running session, so when one member dies every survivor
exits non-zero promptly (`parallel.lockstep.LockstepSessionEnded`). The
supervisor turns that into recovery: it sees the first member exit,
tears the remaining members down, and respawns the WHOLE cluster as a
fresh incarnation on the same ports. Edge senders keep their
reconnect-forever loop and resume streaming into the new incarnation;
viewers re-fetch their streams. ``--max-restarts`` bounds the loop
(exponential backoff between incarnations); ``--no-supervise`` restores
single-shot behaviour.

`--state-file` writes one JSON object per cluster (re)start::

    {"incarnation": 1, "pids": [123, 124],
     "endpoints": [[0, 3000, 3001], [1, 3010, 3011]]}

so external tooling (and the restart test) can watch incarnations and
address individual members without process-name matching.

Extra arguments after ``--`` pass through to every serve process::

    python -m infercam_onnx_tpu_torch.cluster_launch --hosts 2 -- \
        --decode-mode ycbcr
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def _spawn_cluster(args, passthrough):
    """Start all N serve processes; returns (procs, endpoints)."""
    procs: list[subprocess.Popen] = []
    endpoints = []
    for pid in range(args.hosts):
        http = args.http_base + 10 * pid
        ingest = http + 1
        endpoints.append((pid, http, ingest))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "infercam_onnx_tpu_torch.serve",
             "--device", args.device,
             "--server-address", f"127.0.0.1:{http}",
             "--socket-address", f"127.0.0.1:{ingest}",
             "--distributed",
             f"127.0.0.1:{args.coordinator_port},"
             f"num_processes={args.hosts},process_id={pid}",
             "--lockstep-address",
             f"127.0.0.1:{args.lockstep_port}",
             "--data-parallel", "on",
             *passthrough]))
    return procs, endpoints


def _teardown(procs: list[subprocess.Popen], grace_s: float = 15.0):
    """SIGTERM every live member, escalate to SIGKILL after a grace."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + grace_s
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            try:
                p.wait(5)
            except subprocess.TimeoutExpired:
                pass


def _write_state(path, incarnation, procs, endpoints):
    if not path:
        return
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"incarnation": incarnation,
                   "pids": [p.pid for p in procs],
                   "endpoints": [list(e) for e in endpoints]}, f)
    os.replace(tmp, path)  # atomic: readers never see a partial file


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    passthrough: list[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, passthrough = argv[:i], argv[i + 1:]

    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hosts", type=int, default=2,
                    help="number of serve processes (default 2)")
    ap.add_argument("--http-base", type=int, default=3000,
                    help="host i serves HTTP on http_base + 10*i")
    ap.add_argument("--coordinator-port", type=int, default=3999)
    ap.add_argument("--lockstep-port", type=int, default=3998)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="every member's --device (default cuda)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="whole-cluster restarts after a member dies "
                         "(default 5; the lockstep session is fail-stop,"
                         " so recovery is always a full re-formation)")
    ap.add_argument("--stable-uptime", type=float, default=60.0,
                    help="an incarnation that stays healthy this many "
                         "seconds replenishes the restart budget and "
                         "resets the backoff (default 60; a long-lived "
                         "cluster absorbing occasional member deaths, "
                         "e.g. --max-rss-mb recycles, never exhausts the "
                         "budget)")
    ap.add_argument("--no-supervise", action="store_true",
                    help="exit on the first member death instead of "
                         "restarting the cluster")
    ap.add_argument("--state-file", default="",
                    help="write {incarnation, pids, endpoints} JSON "
                         "here on every (re)start")
    args = ap.parse_args(argv)

    # SIGTERM sets a flag instead of raising: an exception injected
    # mid-_teardown (inside p.wait) would unwind past the
    # SIGTERM->SIGKILL escalation and could orphan a hung member. The
    # poll/backoff loops check the flag at their next iteration.
    stop_requested = False

    def _sigterm(*_):
        nonlocal stop_requested
        stop_requested = True

    signal.signal(signal.SIGTERM, _sigterm)

    restarts = 0
    incarnation = 0
    procs: list[subprocess.Popen] = []
    try:
        while not stop_requested:
            incarnation += 1
            procs, endpoints = _spawn_cluster(args, passthrough)
            started = time.time()
            _write_state(args.state_file, incarnation, procs, endpoints)
            for pid, http, ingest in endpoints:
                print(f"host {pid}: http://127.0.0.1:{http}  "
                      f"ingest 127.0.0.1:{ingest}")
            print(f"incarnation {incarnation} up; Ctrl-C stops the "
                  "cluster.", flush=True)

            dead = None
            while dead is None and not stop_requested:
                for p in procs:
                    code = p.poll()
                    if code is not None:
                        dead = (p.pid, code)
                        break
                else:
                    time.sleep(0.5)
            if dead is None:  # stop requested while healthy
                return 0
            print(f"member pid {dead[0]} exited with code {dead[1]}",
                  file=sys.stderr, flush=True)
            # a healthy run replenishes the budget: only *rapid* crash
            # loops should exhaust it, not occasional member deaths
            # spread over a long uptime (e.g. --max-rss-mb recycles)
            if restarts and time.time() - started >= args.stable_uptime:
                print(f"incarnation {incarnation} was healthy for "
                      f">{args.stable_uptime:.0f}s; restart budget "
                      "replenished", file=sys.stderr, flush=True)
                restarts = 0
            # the session is cluster-wide: survivors are already
            # exiting via LockstepSessionEnded; collect them all
            _teardown(procs)
            if args.no_supervise or restarts >= args.max_restarts:
                print("not restarting "
                      f"(restarts used: {restarts}/{args.max_restarts})",
                      file=sys.stderr)
                return dead[1] or 1
            backoff = min(1.0 * (2 ** restarts), 10.0)
            restarts += 1
            print(f"restarting cluster as incarnation "
                  f"{incarnation + 1} in {backoff:.0f}s "
                  f"(restart {restarts}/{args.max_restarts})",
                  file=sys.stderr, flush=True)
            deadline = time.time() + backoff
            while time.time() < deadline and not stop_requested:
                time.sleep(0.2)
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        # shield the final teardown: a second Ctrl-C or a late SIGTERM
        # must not interrupt the SIGTERM->SIGKILL escalation loop
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        _teardown(procs)


if __name__ == "__main__":
    sys.exit(main())
