"""Run one cell of BENCHMARK.json once on this machine's card and print its
result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m benchmark.run`` with the same arguments, from the root of
the checkout).
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
