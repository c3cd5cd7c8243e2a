"""A stand-in for a program's entry in the tests of ``procs.py``:
``main(args)``, misbehaving on request.

    listen PORT       listen on PORT until stopped (the default SIGTERM ends it)
    stubborn PIDFILE  ignore SIGTERM, start a grandchild that sleeps, write
                      its pid to PIDFILE, and sleep
    exit CODE         return CODE at once
"""

import signal
import socket
import subprocess
import sys
import time
from pathlib import Path


def main(args) -> int:
    mode = args[0]
    if mode == "exit":
        return int(args[1])
    if mode == "stubborn":
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        grandchild = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        Path(args[1]).write_text(str(grandchild.pid))
        while True:
            time.sleep(1)
    if mode == "listen":
        with socket.socket() as s:
            s.bind(("127.0.0.1", int(args[1])))
            s.listen()
            while True:
                time.sleep(1)
    raise SystemExit(f"unknown mode {mode!r}")
