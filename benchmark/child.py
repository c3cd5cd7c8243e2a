"""A child process of the benchmark: the program's own entry on one card,
and the answers to the harness's requests (``procs.py``):

    python -m benchmark.child --card <i> --fd <n> -- <module> <args...>

Card ``i`` becomes the process's only card (``CUDA_VISIBLE_DEVICES``, set
before anything imports torch; an index into the harness's own
``CUDA_VISIBLE_DEVICES`` where that is set). The entry,
``<module>.main(args)``, runs on the main thread: an entry may install
signal handlers (the render node stops on SIGTERM), which Python allows
only there. The requests, one JSON object a line on the socket ``--fd``,
are answered on a second thread; the child ends itself when that socket
closes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import socket
import sys
import threading
import time

__all__ = ["main"]


def visible_card(card: int, parent: str = None) -> str:
    """The ``CUDA_VISIBLE_DEVICES`` of a child on card ``card``: an index
    into ``parent``, the harness's own, where that is set."""
    if parent is None:
        return str(card)
    ids = [x.strip() for x in parent.split(",") if x.strip()]
    if not 0 <= card < len(ids):
        raise SystemExit(f"card {card} is not among CUDA_VISIBLE_DEVICES={parent!r}")
    return ids[card]


def own_sockets() -> set:
    """The inodes of this process's sockets, as ``/proc/net/tcp`` names
    them."""
    inodes = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:  # closed since the listing
            continue
        if link.startswith("socket:["):
            inodes.add(link[len("socket:["):-1])
    return inodes


def listening(port: int) -> bool:
    """Whether a TCP socket of this process listens on ``port``. Another
    process's listener there does not count: the harness picks the port
    free, and another process may take it before the entry binds it."""
    mine = own_sockets()
    for name in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(name) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if (len(cols) > 9 and cols[3] == "0A" and int(cols[1].rsplit(":", 1)[1], 16) == port
                    and cols[9] in mine):
                return True
    return False


class Control:
    """The requests of ``procs.ProgramProcess``, answered in order."""

    def __init__(self, card: int, sock: socket.socket):
        self.card, self.sock = card, sock
        self.started = threading.Event()
        self.ended = None  # how the entry ended, once it has
        self.prof = None
        self.t0 = None
        self.summary = None

    def serve(self) -> None:
        with self.sock.makefile("rb") as lines:
            for line in lines:
                req = json.loads(line)
                try:
                    reply = getattr(self, "op_" + req.pop("op"))(**req)
                except Exception as e:  # the harness hears of it and fails the run
                    reply = {"error": f"{type(e).__name__}: {e}"}
                self.sock.sendall((json.dumps(reply, default=str) + "\n").encode())
        os._exit(0)  # the harness has gone: end the entry with it

    def op_ready(self, port=None) -> dict:
        while True:
            if self.ended is not None:
                raise RuntimeError(f"the entry ended: {self.ended}")
            if self.started.is_set() and (port is None or listening(int(port))):
                return {}
            time.sleep(0.02)

    def op_window_start(self, trace: bool) -> dict:
        import torch

        from benchmark.harness import launch_counters

        for c in launch_counters():
            c.clear()
        if torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.summary = None
        self.t0 = time.perf_counter()
        return {}

    def op_window_end(self) -> dict:
        window_s = time.perf_counter() - self.t0
        if self.prof is not None:
            from benchmark import trace as tr

            self.prof.__exit__(None, None, None)
            # Every device event of this process is on its one card; it
            # counts no card but its own.
            self.summary = tr.reduce(*tr.events(self.prof, card=self.card), window_s, cards=0)
            self.prof = None
        return {}

    def op_report(self) -> dict:
        import torch

        from benchmark.harness import forbidden_modules, launch_counters

        try:
            from flux_tpu_torch.metrics import spans
        except ImportError:
            def spans():
                return []
        cuda = torch.cuda.is_initialized()
        return {
            "launches": {k: v for c in launch_counters() for k, v in c.items()},
            "card": torch.cuda.get_device_name(0) if cuda else None,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0,
            "forbidden": forbidden_modules(),
            "trace": None if self.summary is None else dataclasses.asdict(self.summary),
            "spans": [[s.id, s.name, s.start_ns, s.end_ns, s.thread, s.thread_ident, s.thread_name,
                       None if s.job is None else str(s.job), s.parent, s.attrs] for s in spans()],
        }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" not in argv:
        raise SystemExit("usage: python -m benchmark.child --card <i> --fd <n> -- <module> <args...>")
    cut = argv.index("--")
    own, (module, *args) = dict(zip(argv[:cut:2], argv[1:cut:2])), argv[cut + 1:]
    card = int(own["--card"])
    os.environ["CUDA_VISIBLE_DEVICES"] = visible_card(card, os.environ.get("CUDA_VISIBLE_DEVICES"))
    ctl = Control(card, socket.socket(fileno=int(own["--fd"])))
    threading.Thread(target=ctl.serve, name="benchmark-control", daemon=True).start()
    entry = importlib.import_module(module).main
    ctl.started.set()
    try:
        rc = entry(args)
    except BaseException as e:
        ctl.ended = f"{type(e).__name__}: {e}"
        raise
    ctl.ended = f"returned {rc!r}"
    return rc


if __name__ == "__main__":
    sys.exit(main())
