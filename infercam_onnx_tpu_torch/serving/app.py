"""Server wiring (``infercam_onnx_tpu/serving/app.py``; the reference's
infer_server binary): ingest queue, data socket, router, micro-batched
inference worker, HTTP endpoints and meter logger as asyncio tasks in one
process, on one device or over a mesh of replicas (``data_parallel``),
alone or as one member of a lockstep cluster (``lockstep_address``, under
a ``torch.distributed`` group: `parallel.multihost`).

With ``link_adaptive`` the worker probes the host->device link on its
device thread before the warm-up (which then runs the paths that will
serve), and again every ``link_probe_period_s`` seconds where that is
set; ``/stats`` shows the decisions under ``link`` (``serving/link.py``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import signal
import sys

import torch

from infercam_onnx_tpu_torch.config import (
    DetectorConfig,
    EngineConfig,
    ServerConfig,
)
from infercam_onnx_tpu_torch.detector import Detector
from infercam_onnx_tpu_torch.ops import nms
from infercam_onnx_tpu_torch.parallel.lockstep import (LockstepDetector,
                                                       LockstepSessionEnded)
from infercam_onnx_tpu_torch.parallel.mesh import make_mesh
from infercam_onnx_tpu_torch.parallel.multihost import (process_count,
                                                        process_index)
from infercam_onnx_tpu_torch.serving.data_socket import (DataSocket,
                                                         spawn_data_socket)
from infercam_onnx_tpu_torch.serving.http import HttpServer
from infercam_onnx_tpu_torch.serving.inferer import InferenceWorker
from infercam_onnx_tpu_torch.serving.meter import meter_logger
from infercam_onnx_tpu_torch.serving.router import FrameRouter

log = logging.getLogger("infercam.app")


@dataclasses.dataclass
class InferServer:
    """Running server handle (owned tasks + listeners)."""

    router: FrameRouter
    worker: InferenceWorker
    http: HttpServer
    tasks: list[asyncio.Task]
    data_server: DataSocket

    @property
    def http_port(self) -> int:
        return self.http.port

    @property
    def socket_port(self) -> int:
        return self.data_server.port

    async def close(self) -> None:
        # closes the listener AND the senders' connections, so senders
        # see the shutdown and enter their reconnect loop
        self.data_server.close()
        await self.http.close()
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        # let the stage threads finish the batches they hold
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.worker.close)
        # a lockstep member leaves its cluster session, so the other
        # members' pumps stop waiting (it ends the session for all)
        close_det = getattr(self.worker._detector, "close", None)
        if close_det is not None:
            await loop.run_in_executor(None, close_det)
        try:
            await asyncio.wait_for(self.data_server.wait_closed(), 5.0)
        except asyncio.TimeoutError:
            pass


def _split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def topology(detector: Detector, *, lockstep: bool = False) -> dict:
    """What /stats and /metrics report of the deployment: the devices of
    the whole cluster (this process's replicas times the processes, as
    ``jax.devices()`` is global under ``jax.distributed``), the processes,
    and whether dispatch runs in lockstep."""
    dev = detector.device
    local = len(getattr(detector, "mesh", None) or [dev])
    return {
        "devices": local * process_count(),
        "processes": process_count(),
        "lockstep": lockstep,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "detector": type(detector).__name__,
    }


async def start_server(
    server_config: ServerConfig = ServerConfig(),
    detector_config: DetectorConfig = DetectorConfig(),
    engine_config: EngineConfig = EngineConfig(),
    detector: Detector | None = None,
    warmup_resolutions: list[tuple[int, int]] | None = None,
    warmup_async: bool = False,
    device: str | torch.device = "cuda",
    weights: str | None = None,
    data_parallel: str = "auto",
    mesh: list | None = None,
    lockstep_address: str | None = None,
) -> InferServer:
    """Start every task of the server and return its handle.

    Without ``detector`` one is built from ``detector_config`` on
    ``device`` (with the .npz ``weights``, else random ones). The warm-up
    (`InferenceWorker.warmup` over ``warmup_resolutions``) runs on the
    worker's device thread: before the listeners open, or with
    ``warmup_async`` while they already serve (raw streams flow at once,
    inference starts when it ends; /stats says "warming" meanwhile).

    ``data_parallel``: "auto" splits batches over this process's cards
    (`parallel.mesh.make_mesh`) when the cluster has more than one device
    (the cards here times the processes of the group), "on" requires
    that, "off" serves on ``device`` alone. An explicit ``mesh`` (a list of
    devices) overrides the policy. ``lockstep_address`` (``host:port`` of
    the coordinator, which process 0 runs) makes this process a member of
    a lockstep cluster (`parallel.lockstep`); it needs a mesh."""
    if mesh is None and data_parallel != "off":
        local = (torch.cuda.device_count()
                 if torch.device(device).type == "cuda" else 1)
        if local * process_count() > 1:
            mesh = make_mesh(local, device=device)
            log.info("data-parallel serving over %d local device(s), %d "
                     "process(es)", local, process_count())
        elif data_parallel == "on":
            raise ValueError(
                "--data-parallel on requires >1 device, have 1")
    if detector is None:
        detector = Detector(detector_config, weights=weights,
                            device=mesh[0] if mesh else device)

    if lockstep_address:
        # every member of the cluster runs the same programs in the same
        # order (parallel/lockstep.py)
        if mesh is None:
            raise ValueError("--lockstep-address requires a mesh "
                             "(--data-parallel must not be off)")
        detector = LockstepDetector(
            detector, mesh, lockstep_address,
            coordinator=process_index() == 0, n_processes=process_count(),
            ladder=engine_config.batch_buckets)
        log.info("lockstep dispatch joined: process %d/%d", process_index(),
                 process_count())

    worker = InferenceWorker(detector, engine_config, server_config,
                             mesh=mesh)
    detector = worker._detector
    router = FrameRouter(worker.submit, server_config)
    queue: asyncio.Queue = asyncio.Queue(
        maxsize=server_config.ingest_capacity)

    def warm():
        try:
            if engine_config.link_adaptive:
                status = worker.probe_and_adapt()
                log.info("link probe: %.0f MB/s -> decode mode %s (%s)",
                         status["h2d_mbps"], status["decode_mode"],
                         status["why"])
            if warmup_resolutions:
                log.info("warming up for %s", warmup_resolutions)
                worker.warmup(warmup_resolutions)
                log.info("device warm-up complete")
        finally:
            worker.warming = False

    worker.warming = True
    # the device executor has one thread, so the warm-up ends before any
    # batch is dispatched
    warm_fut = asyncio.get_running_loop().run_in_executor(
        worker._device_exec, warm)
    if warmup_async:
        def _warm_done(f):
            # a failed warm-up must not leave the server silently warm
            if not f.cancelled() and f.exception() is not None:
                log.error("device warm-up FAILED: %r", f.exception())

        warm_fut.add_done_callback(_warm_done)
    else:
        await warm_fut

    host, port = _split_addr(server_config.socket_address)
    data_server = await spawn_data_socket(queue, host, port)

    is_lockstep = isinstance(detector, LockstepDetector)

    def lockstep_counts() -> dict:
        coord = detector._coord
        return {"process": process_index(), "processes": process_count(),
                "dispatches": detector.dispatches,
                "nms_launches": nms.kernel.launches,
                "rounds": None if coord is None else coord.rounds,
                "session_ended": detector.session_ended}

    http = HttpServer(router,
                      topology=topology(detector,
                                        lockstep=bool(lockstep_address)),
                      warming=lambda: worker.warming,
                      link=lambda: worker.link_status,
                      lockstep=lockstep_counts if is_lockstep else None)
    hhost, hport = _split_addr(server_config.http_address)
    await http.start(hhost, hport)

    async def supervised(name: str, factory, *, backoff_s: float = 1.0):
        """Restart a crashed core task after a backoff (the reference's
        inference task dies silently on a panic)."""
        while True:
            try:
                await factory()
                return  # clean exit
            except asyncio.CancelledError:
                raise
            except LockstepSessionEnded:
                # terminal: the session cannot be rejoined, and a restarted
                # worker would serve nothing; the process exits non-zero so
                # a supervisor restarts the cluster as a unit
                log.error("%s: lockstep session ended; terminal, stopping "
                          "the server", name)
                raise
            except Exception:
                log.exception("%s task crashed; restarting in %.1fs",
                              name, backoff_s)
                await asyncio.sleep(backoff_s)

    async def lockstep_watch():
        # a dead session is terminal for the process, but demand-driven
        # serving may never dispatch again to notice: poll it and raise, so
        # serve_forever exits non-zero and a supervisor restarts the cluster
        while not detector.session_ended:
            await asyncio.sleep(0.5)
        raise LockstepSessionEnded(
            "lockstep session has ended (peer left or dispatch diverged); "
            "restart the cluster as a unit")

    tasks = [
        asyncio.create_task(
            supervised("router", lambda: router.run(queue)),
            name="router"),
        asyncio.create_task(
            supervised("inferer", worker.run), name="inferer"),
        asyncio.create_task(
            supervised("meter", lambda: meter_logger(
                server_config.meter_period_s)), name="meter"),
    ]
    if lockstep_address:
        tasks.append(asyncio.create_task(lockstep_watch(),
                                         name="lockstep-watch"))
    if engine_config.link_adaptive and engine_config.link_probe_period_s:
        async def link_reprobe():
            # on the device thread, between dispatches: a recovered link
            # restores the configured paths, a degraded one re-routes them
            loop = asyncio.get_running_loop()
            while True:
                await asyncio.sleep(engine_config.link_probe_period_s)
                await loop.run_in_executor(worker._device_exec,
                                           worker.probe_and_adapt)

        tasks.append(asyncio.create_task(
            supervised("link-reprobe", link_reprobe), name="link-reprobe"))
    if server_config.max_rss_mb:
        # a lockstep member cannot re-exec into its running session: it
        # exits with a code of its own, and the cluster supervisor
        # (cluster_launch.py) re-forms the whole cluster; a server on its
        # own re-execs itself and its senders reconnect
        tasks.append(asyncio.create_task(
            rss_watchdog(server_config.max_rss_mb,
                         server_config.rss_check_period_s,
                         on_breach=(_exit_for_supervisor
                                    if hasattr(detector, "session_ended")
                                    else _reexec)),
            name="rss-watchdog"))
    return InferServer(router=router, worker=worker, http=http, tasks=tasks,
                       data_server=data_server)


def _read_rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _reexec() -> None:
    """Replace this process with a fresh copy of itself. Every fd closes
    on exec, so the listeners free their ports and senders reconnect."""
    # sys.orig_argv is the interpreter's own command line ("-m module"
    # included); execv needs an absolute interpreter path
    argv = [sys.executable] + list(sys.orig_argv[1:])
    log.warning("re-executing: %s", argv)
    os.execv(argv[0], argv)


# tells a supervisor an RSS recycle from a crash
RSS_RECYCLE_EXIT_CODE = 17


def _exit_for_supervisor() -> None:
    """A lockstep member's RSS breach: exit at once with
    `RSS_RECYCLE_EXIT_CODE`. The other members see the session end and
    exit too; the cluster supervisor re-forms the whole cluster, and the
    senders reconnect. ``os._exit``: a graceful interpreter teardown
    would wait on the process group's threads."""
    log.warning("exiting for cluster supervisor re-formation (exit code "
                "%d)", RSS_RECYCLE_EXIT_CODE)
    os._exit(RSS_RECYCLE_EXIT_CODE)


async def rss_watchdog(max_rss_mb: int, period_s: float = 10.0,
                       *, read_rss=_read_rss_mb,
                       on_breach=_reexec) -> None:
    """Re-exec the process when its RSS crosses the cap (a guard against
    a leaking dependency; senders see a short restart)."""
    while True:
        await asyncio.sleep(period_s)
        rss = read_rss()
        if rss > max_rss_mb:
            log.warning("RSS %.0f MiB exceeds cap %d MiB; recycling "
                        "server process", rss, max_rss_mb)
            on_breach()
            return


async def serve_forever(**kwargs) -> None:
    """`start_server` and serve until SIGTERM or a core task's terminal
    failure; then close."""
    server = await start_server(**kwargs)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    try:
        loop.add_signal_handler(signal.SIGTERM, stop.set)
    except (NotImplementedError, RuntimeError):  # non-unix / nested loop
        pass
    try:
        waiter = asyncio.create_task(stop.wait())
        done, _ = await asyncio.wait(
            {waiter, *server.tasks},
            return_when=asyncio.FIRST_COMPLETED)
        if waiter in done:
            log.info("SIGTERM received; shutting down")
        waiter.cancel()
        for t in done - {waiter}:
            if not t.cancelled() and t.exception() is not None:
                raise t.exception()
    finally:
        await server.close()
