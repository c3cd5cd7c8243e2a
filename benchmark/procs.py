"""The program's device work in child processes of the harness, one card
each.

A driver whose cell renders in several processes (render nodes, say)
starts each through :class:`ProgramProcess`, which runs

    python -m benchmark.child --card <i> --fd <n> -- <module> <args...>

in a process group of its own. The child makes card ``i`` its only card,
runs ``<module>.main(args)``, the program's own entry, and answers the
harness on a control channel, a Unix socket pair with one JSON object a
line (``child.py``):

* ``ready`` [``port``]: the entry has started and, where a port is named,
  a socket of the child's own listens on it;
* ``window_start`` ``trace``: the launch counters cleared, the card's peak
  memory reset and, with ``trace``, a ``torch.profiler`` window opened,
  which also switches the program's span recorder on;
* ``window_end``: the window closed, and the child's own trace reduced
  (``trace.events``, ``trace.reduce``);
* ``report``: launches by kernel configuration, the card's name and peak
  memory, the forbidden modules the child holds, the trace summary and
  the program's spans.

Every request has a deadline. A child that misses one, answers with an
error or exits raises :class:`ChildFailed`, and the harness counts the run
failed. :meth:`ProgramProcess.close` ends the child's whole process group
and waits for it; a child whose control channel closes (the harness gone)
ends itself.

The spans' times are ``time.perf_counter_ns()``, which is CLOCK_MONOTONIC
on Linux: one clock for every process of the machine, so the harness's
frame times (``time.perf_counter``) window a child's spans as they window
its own.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from collections import namedtuple

from .harness import REPO_DIR
from .trace import TraceSummary

__all__ = ["ChildFailed", "ProcessSpan", "ProgramProcess", "free_port"]

# One span of a child, as ``flux_tpu_torch.metrics.Span`` with the child's
# card in front and the job id as text.
ProcessSpan = namedtuple("ProcessSpan", ("card", "id", "name", "start_ns", "end_ns", "thread", "thread_ident",
                                         "thread_name", "job", "parent", "attrs"))


class ChildFailed(RuntimeError):
    """A child process missed a request's deadline, answered it with an
    error, or exited."""


def free_port() -> int:
    """A TCP port of the loopback interface that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProgramProcess:
    """One child process running the program's entry ``argv`` (a module
    name and its arguments) on card ``card``, in the harness's
    environment. ``deadline_s`` is each request's deadline unless the
    request names its own."""

    def __init__(self, card: int, argv, deadline_s: float = 60.0):
        self.card, self.argv, self.deadline_s = int(card), [str(a) for a in argv], float(deadline_s)
        self._sock, theirs = socket.socketpair()
        self._chunks = []
        try:
            self._popen = subprocess.Popen(
                [sys.executable, "-m", "benchmark.child", "--card", str(self.card), "--fd", str(theirs.fileno()),
                 "--", *self.argv],
                cwd=REPO_DIR, stdin=subprocess.DEVNULL,
                stdout=2,  # the program's prints go to the harness's standard error, never its result line
                pass_fds=(theirs.fileno(),), start_new_session=True)
        except BaseException:
            self._sock.close()
            raise
        finally:
            theirs.close()
        self.pid = self._popen.pid

    def __repr__(self) -> str:
        return f"child on card {self.card} (pid {self.pid}, {self.argv[0] if self.argv else '?'})"

    def alive(self) -> bool:
        return self._popen.poll() is None

    def request(self, op: str, deadline_s: float = None, **args) -> dict:
        """Send ``op`` with ``args`` and return the child's answer, within
        the deadline."""
        if self._sock is None:
            raise ChildFailed(f"{self}: closed")
        limit = self.deadline_s if deadline_s is None else float(deadline_s)
        deadline = time.monotonic() + limit
        try:
            self._sock.settimeout(limit)
            self._sock.sendall((json.dumps({"op": op, **args}) + "\n").encode())
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError
                self._sock.settimeout(left)
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    raise ChildFailed(f"{self}: exited (code {self._popen.poll()}) before answering {op}")
                head, nl, rest = chunk.partition(b"\n")
                self._chunks.append(head)
                if nl:
                    line, self._chunks = b"".join(self._chunks), [rest] if rest else []
                    break
        except TimeoutError:
            raise ChildFailed(f"{self}: no answer to {op} within {limit:g} s") from None
        except OSError as e:
            raise ChildFailed(f"{self}: {op}: {e}") from None
        reply = json.loads(line)
        if "error" in reply:
            raise ChildFailed(f"{self}: {op}: {reply['error']}")
        return reply

    def ready(self, port: int = None, deadline_s: float = None) -> None:
        """Wait until the entry has started and, where ``port`` is given,
        the child itself listens on it."""
        self.request("ready", deadline_s, port=port)

    def window_start(self, trace: bool) -> None:
        self.request("window_start", trace=bool(trace))

    def window_end(self) -> None:
        self.request("window_end")

    def report(self) -> dict:
        """``launches`` (configuration -> count), ``card`` (the card's name,
        None off the card), ``memory_peak_bytes``, ``forbidden`` (module
        names), ``trace`` (a :class:`~benchmark.trace.TraceSummary`, None
        untraced) and ``spans`` (:class:`ProcessSpan`)."""
        r = self.request("report")
        t = r["trace"]
        if t is not None:
            r["trace"] = TraceSummary(**{**t, "busy_by_card": {int(k): v for k, v in t["busy_by_card"].items()}})
        r["spans"] = [ProcessSpan(self.card, *s) for s in r["spans"]]
        return r

    def close(self, grace_s: float = 5.0) -> None:
        """End the child's process group: SIGTERM, which lets the entry stop
        cleanly, then SIGKILL to whatever of the group is left; wait for the
        child. Safe to call again."""
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 30.0)):
            try:
                os.killpg(self.pid, sig)
            except ProcessLookupError:
                break
            try:
                self._popen.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                pass
        if self._popen.poll() is None:
            raise ChildFailed(f"{self}: still alive after SIGKILL")
