"""The readings a limit is set from: for each seed, one short window of a
cell at its own load through the program, then the numbers the check
compares, for the program and, on the control seeds, for the control (the
reference with its state in bfloat16 in the program's place). One process
for all seeds, so that set-up is paid once.

    python3 benchmark/tools/readings.py --workload <cell> --seconds 5 \
        --seeds 11 12 13 ... --control-seeds 11 12 13 [--device cpu]

Prints one JSON line per seed and side.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import BENCH_DIR, Spans, load_json, load_module, load_spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    spec = load_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config = load_json("configs", cell["config"])
    mix = load_json("mixes", cell["traffic"])
    drv = load_module("drivers", mix["driver"]).Driver(
        config=config, mix=mix, scene_path=str(BENCH_DIR / "configs" / config["scene"]),
        device=torch.device(args.device), seed=args.seeds[0], spans=Spans())
    drv.setup()
    for seed in args.seeds:
        drv.seed = seed
        t = time.perf_counter()
        drv.window(args.seconds)
        w = time.perf_counter() - t
        t = time.perf_counter()
        got = drv.verify()
        line = {"workload": args.workload, "seed": seed, "side": "program", "attempted": drv.attempted,
                "failed": drv.failed, "window_s": w, "check_s": time.perf_counter() - t, **got}
        print(json.dumps(line), flush=True)
        if seed in args.control_seeds:
            print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                              **drv.verify(control=True)}), flush=True)
    drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
