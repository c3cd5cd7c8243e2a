"""Render-node daemon: serves this host's CUDA cards to a remote master
(``flux_tpu/node.py``; flux-node/src/main.rs).

Listens on 0.0.0.0:2000 by default and keeps one LocalWorker for the
process lifetime (main.rs:160). Per connection: send the WorkerInfo
handshake (main.rs:26-31), then dispatch ``set_job`` / ``work_unit`` /
``done`` frames into the worker while a forwarder thread streams the
results back as ``rows_ready`` (or ``job_error``) frames (main.rs:41-55).
The frames are ``flux_tpu.node``'s, so a master of either package drives a
node of either.

As in ``flux_tpu``, every master is accepted at once on its own thread (the
reference serves one at a time, main.rs:96-111); the handshake carries
``busy``/``queued`` status, and jobs queue on the shared LocalWorker.

Run: ``python -m flux_tpu_torch.node -p 2099`` (on the cards; ``-t N``
serves the first N, a device mesh where more than one), or with
``--device cpu`` (the plain PyTorch version); then
``python -m flux_tpu_torch.cli scenes/demo1.yml -r 2 -n localhost:2099 -L``.
"""

from __future__ import annotations

import queue
import signal
import socket
import threading
import time

import torch

from .constants import DEFAULT_PORT
from .debug import d_println, set_debug
from .job import Job, WorkUnit
from .manager import JobFailed, RowsReady, WaitGroup
from .parallel import local_devices
from .render import resolve_device
from .workers import LocalWorker
from . import wire

__all__ = ["serve", "handle_client"]


def handle_client(conn: socket.socket, worker: LocalWorker) -> None:
    """Serve one master connection (flux-node/src/main.rs:20-91)."""
    info = worker.info()
    wire.send_msg(
        conn,
        {
            "type": "worker_info",
            "num_devices": info.num_devices,
            "platform": info.platform,
            # Concurrent-master status: a second master connects fine but
            # its jobs queue behind the active one (see module docstring).
            "busy": worker.busy,
            "queued": worker.queued_jobs,
        },
    )

    unit_queue = None
    sink = None
    forwarder = None
    wg = None

    def forward_events(q: "queue.Queue", allow_compress: bool) -> None:
        while True:
            ev = q.get()
            if ev is None:
                return
            try:
                if isinstance(ev, RowsReady):
                    wire.send_msg(
                        conn,
                        wire.encode_rows(
                            ev.result.work_unit.row_start, ev.result.rows,
                            allow_compress=allow_compress,
                        ),
                    )
                elif isinstance(ev, JobFailed):
                    wire.send_msg(conn, {"type": "job_error", "reason": ev.reason})
            except OSError:
                return

    def finish_job():
        nonlocal unit_queue, sink, forwarder, wg
        if unit_queue is not None:
            unit_queue.put(None)
            if wg is not None:
                wg.wait(timeout=600)
            if sink is not None:
                sink.put(None)
            if forwarder is not None:
                forwarder.join(timeout=30)
        unit_queue = sink = forwarder = wg = None

    try:
        while True:
            try:
                msg = wire.recv_msg(conn)
            except (ConnectionError, OSError):
                break
            kind = msg.get("type")
            if kind == "set_job":
                finish_job()
                job = Job.from_dict(msg["job"])
                d_println(f"node: set_job {job.id}")
                # Capability gate: only deflate row blocks when THIS master
                # advertised support (older masters read raw f32 bytes).
                allow_compress = "zlib-rows" in msg.get("caps", [])
                unit_queue = queue.Queue()
                sink = queue.Queue()
                wg = WaitGroup()
                wg.add(1)
                forwarder = threading.Thread(
                    target=forward_events, args=(sink, allow_compress), daemon=True
                )
                forwarder.start()
                worker.handle().send(job, unit_queue, sink, wg)
            elif kind == "work_unit":
                if unit_queue is None:
                    # Malformed client; drop the connection, keep serving.
                    d_println("node: work_unit before set_job")
                    break
                unit_queue.put(
                    WorkUnit(
                        row_start=int(msg["row_start"]),
                        row_end=int(msg["row_end"]),
                        job_id=None,
                    )
                )
            elif kind == "done":
                d_println("node: job done")
                finish_job()
            elif kind == "shutdown":
                break
            else:
                d_println(f"node: unexpected message {kind!r}")
                break
    finally:
        finish_job()
        conn.close()


def serve(host: str = "0.0.0.0", port: int = DEFAULT_PORT, *, max_connections=None,
          ready_event: threading.Event = None, device=None, devices: int = None) -> None:
    """Accept loop — one thread per master (contrast: the reference serves
    serially, flux-node/src/main.rs:96-111,141-152).

    ``device`` is what the node's renderer runs on (the CUDA card unless the
    CPU is named); ``devices`` limits how many of its cards the node's
    renderer drives (the flux-node ``-t`` threads analog; default all; on
    the CPU, that many shards), a device mesh where more than one.
    ``max_connections`` bounds how many connections are ACCEPTED in total
    (tests use it to bound the daemon's life); the daemon exits once they
    all complete."""
    worker = LocalWorker(name="node", devices=local_devices(device, devices))
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    print(f"flux-node-torch: listening on {host}:{port}", flush=True)
    if ready_event is not None:
        ready_event.set()
    accepted = 0
    threads = []
    try:
        while max_connections is None or accepted < max_connections:
            conn, addr = srv.accept()
            accepted += 1
            d_println(f"node: connection from {addr}")
            # One thread per master; jobs serialize on the shared worker.
            t = threading.Thread(
                target=handle_client, args=(conn, worker),
                name=f"node-client[{addr}]", daemon=True,
            )
            t.start()
            # Prune finished threads so a long-lived daemon (the
            # max_connections=None default, where the join loop below is
            # unreachable) doesn't accumulate one Thread object per master.
            threads = [x for x in threads if x.is_alive()]
            threads.append(t)
        for t in threads:
            t.join()
    finally:
        srv.close()
        worker.stop()


def prepare_card(dev: torch.device) -> None:
    """Create the card's context, and build (where they are not built yet)
    and load both kernel libraries, before the node listens: a master's
    first unit then pays neither. Run on each card the node serves."""
    from .ops import build

    torch.zeros(1, device=dev)
    build.build_many(list(build.LIBRARIES))
    for lib in build.LIBRARIES:
        build.load(lib)


def main(argv=None) -> int:
    """flux-node CLI (flux-node/src/main.rs:119-152): ``-H/--host``,
    ``-p/--port``, ``-t/--devices`` (how many local devices to serve),
    ``--verbose`` and ``--device`` (``cuda`` by default; raises without a
    card unless ``cpu``)."""
    import argparse

    p = argparse.ArgumentParser(prog="flux-tpu-torch-node", description="Render node daemon")
    p.add_argument("-H", "--host", default="0.0.0.0")
    p.add_argument("-p", "--port", type=int, default=DEFAULT_PORT)
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default) runs the megakernels; cpu their plain PyTorch version",
    )

    def _positive(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    p.add_argument(
        "-t", "--devices", type=_positive, default=None,
        help="local devices to serve (default: all; with --device cpu, that many CPU shards)",
    )
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.verbose:
        set_debug(True)
    dev = resolve_device(args.device)
    devs = local_devices(dev, args.devices)
    n = torch.cuda.device_count() if dev.type == "cuda" else len(devs)
    name = torch.cuda.get_device_name(devs[0]) if dev.type == "cuda" else "the CPU"
    print(f"flux-node-torch: serving {len(devs)} of {n} local devices ({dev.type}: {name})", flush=True)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        for d in dict.fromkeys(devs):
            prepare_card(d)
        print(f"flux-node-torch: context and kernels ready in {time.perf_counter() - t0:.2f} s", flush=True)

    def stop(signum, frame):
        raise KeyboardInterrupt

    # SIGTERM, like Ctrl-C, stops the node cleanly: exit code 0.
    signal.signal(signal.SIGTERM, stop)
    try:
        serve(host=args.host, port=args.port, device=dev, devices=args.devices)
    except KeyboardInterrupt:
        print("flux-node-torch: stopped", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
