"""A driver for the benchmark's own tests: ``job_frames``' whole frames,
rendered by render nodes in child processes of the harness. A
``RenderManager`` over one ``NetworkWorker`` a node, each reaching a
``flux_tpu_torch.node -t 1`` on a loopback port, which runs in a
``procs.ProgramProcess`` on a card of its own. The harness closes the
children once the run is over.

Mix keys beside ``job_frames``': ``nodes``, the number of nodes (cards
``0 .. nodes - 1``); ``kill_after_frames``, for the test of a child that
dies, kills the first node's process group once that many window frames
have ended.
"""

import os
import signal

from benchmark.drivers.job_frames import Driver as FramesDriver
from benchmark.procs import ProgramProcess, free_port

READY_S = 900.0  # a node's first start in a checkout builds the kernels
REQUEST_S = 120.0
IO_S = 120.0  # a node's unit, or a send to it


class Driver(FramesDriver):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.procs = []

    def _workers(self) -> list:
        from flux_tpu_torch.workers import NetworkWorker

        ports = [free_port() for _ in range(int(self.mix["nodes"]))]
        for card, port in enumerate(ports):
            self.procs.append(ProgramProcess(
                card, ["flux_tpu_torch.node", "-H", "127.0.0.1", "-p", port, "-t", 1, "--device", self.device.type],
                deadline_s=REQUEST_S))
        for p, port in zip(self.procs, ports):
            p.ready(port=port, deadline_s=READY_S)
        return [NetworkWorker(f"127.0.0.1:{port}", io_timeout=IO_S) for port in ports]

    def _frame(self, index: int, seed: int):
        rec = super()._frame(index, seed)
        if index + 1 == self.mix.get("kill_after_frames"):
            os.killpg(self.procs[0].pid, signal.SIGKILL)
        return rec

    def processes(self) -> list:
        return self.procs
