"""Freeze a final-frame cell's float32 operation count for
``kernel_roofline_pct``: one frame of the cell at its render seed of
``--seed 0``, frame 0, through the kernel's counting launch, one launch a
work unit as the job path cuts the frame; the work counters summed over the
frame; and the operations they give by ``benchmark/roofline.py``. Run once,
on the card:

    python3 benchmark/tools/freeze_counts.py --workload <cell> --commit <rev> --out DIR

writes ``DIR/<cell>.json``, to be kept as ``benchmark/frozen/<cell>.json``.
It also prints the program's own bound for the same counters, which must
agree today and may drift later: the frozen file does not.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import roofline  # noqa: E402
from benchmark.harness import BENCH_DIR, frame_seed, load_json, load_spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--commit", required=True, help="the commit whose kernels are counted")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from flux_tpu_torch.ops import scene_kernel, sweep_kernel
    from flux_tpu_torch.render import Renderer
    from flux_tpu_torch.scene import MaterialKind, load_scene

    spec = load_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    config, mix = load_json("configs", cell["config"]), load_json("mixes", cell["traffic"])
    sd = load_scene(str(BENCH_DIR / "configs" / config["scene"]))
    seed, root, rows = frame_seed(0, 0), int(mix["sample_root"]), int(mix["rows_per_unit"])
    r = Renderer(sd, root, int(config["depth"]), seed=seed, device="cuda", nee=bool(mix.get("nee")),
                 physical=bool(mix.get("physical")))
    names = sweep_kernel.COUNT_NAMES if r.uses_sweep_kernel else scene_kernel.COUNT_NAMES
    nc = sweep_kernel.n_counts(r.nee, r.physical) if r.uses_sweep_kernel else scene_kernel.N_COUNTS
    total = [0] * nc
    for row0 in range(0, r.height, rows):
        n = min(rows, r.height - row0)
        kw = dict(img_w=r.width, img_h=r.height, n_rows=n, n_samples=root * root, root=root,
                  max_depth=r.max_depth, lights=r.lights, physical=r.physical)
        counts = torch.zeros((n * r.width,) if nc == 1 else (nc, n * r.width), dtype=torch.int32, device="cuda")
        if r.uses_sweep_kernel:
            sweep_kernel.render_block_sweep(r.scene, r.cam, row0, 0, r.seed, bounce_counts=counts, **kw)
        else:
            scene_kernel.render_block_scene(r.scene, r.cam, row0, 0, r.seed, isect=r.isect, work_counts=counts, **kw)
        torch.cuda.synchronize()
        part = counts.to(torch.int64).reshape(nc, -1).sum(dim=1).tolist()
        total = [a + b for a, b in zip(total, part)]
    c = dict(zip(names, total))
    samples = r.width * r.height * root * root
    mirror = bool((r.scene.host["mat_kind"] == MaterialKind.REFLECTIVE).any())
    tri_share = 0.0
    if r.lights is not None and r.lights.has_tris:
        tri_share = float(r.lights.host["pick"][r.lights.host["is_tri"] > 0.5].sum())
    facts = dict(n_spheres=r.scene.num_spheres, n_planes=r.scene.num_planes, mirror=mirror)
    if r.uses_sweep_kernel:
        work = [c.get(k, 0) for k in ("bounces", "light_samples", "shadow_rays", "reverse_densities", "glossy_lobes")]
        ops = roofline.sweep_ops(**facts, n_samples=samples, bounces=work[0], physical=r.physical,
                                 light_samples=work[1], shadow_rays=work[2], reverse_densities=work[3],
                                 glossy_lobes=work[4])
        program = sweep_kernel.flops_lower_bound(r.scene, samples, work[0], physical=r.physical,
                                                 light_samples=work[1], shadow_rays=work[2],
                                                 reverse_densities=work[3], glossy_lobes=work[4])
        kernel = "sweep_megakernel"
    else:
        ops = roofline.scene_ops(**facts, scans=r.isect.scans, n_samples=samples, counts=c, physical=r.physical,
                                 tri_light_fraction=tri_share)
        program = scene_kernel.flops_lower_bound(r.scene, r.isect, samples, c, physical=r.physical,
                                                 tri_light_fraction=tri_share)
        kernel = "scene_megakernel"
    out = {
        "cell": args.workload, "kernel": kernel, "ops_per_frame": int(ops), "samples_per_frame": samples,
        "render_seed": seed, "launches_per_frame": len(range(0, r.height, rows)),
        "work_counts": {k: v for k, v in c.items() if not k.startswith("clk_")},
        "scene": {**facts, "tri_light_fraction": tri_share},
        "program_bound_at_freeze": int(program), "device": torch.cuda.get_device_name(0),
        "commit": args.commit,
        "command": f"python3 benchmark/tools/freeze_counts.py --workload {args.workload} --commit {args.commit} --out DIR",
    }
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.workload}.json").write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0 if int(ops) == int(program) else 1


if __name__ == "__main__":
    sys.exit(main())
