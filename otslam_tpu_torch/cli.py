"""Command-line interface of the port (counterpart of otslam_tpu/cli.py).

  reconstruct   3d_model/reconstruct_rgbd[_filter|_gt].py, multi_reconstruct
  eval          eval/eval_*.py (analytic GT scenarios or a GT ply)

Same flags as the JAX package's subcommands, plus ``--device``. Run as
``python -m otslam_tpu_torch.cli <subcommand> ...``.
"""

from __future__ import annotations

import argparse
import json
import os


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu); a CUDA "
                        "device without CUDA is an error, not a CPU run")


def _add_reconstruct(sub):
    p = sub.add_parser("reconstruct", help="TSDF-reconstruct objects from a "
                       "capture dataset")
    p.add_argument("--dataset", required=True)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--object", default=None, help="single object name")
    p.add_argument("--backend", default="pallas",
                   choices=["pallas", "sparse", "dense"])
    p.add_argument("--mesh", action="store_true",
                   help="save triangle meshes instead of filtered clouds "
                        "(not ported yet)")
    p.add_argument("--no-z-filter", action="store_true")
    p.add_argument("--gt-poses", action="store_true",
                   help="dataset captured with ground-truth body poses "
                        "(reconstruct_rgbd_gt.py T_fix variant)")
    p.add_argument("--ranges", default=None,
                   help='explicit frame ranges, e.g. "Object_0:1-16,Object_1:2-9"')
    p.add_argument("--auto-origin", action="store_true",
                   help="center each object's volume on its observed geometry")
    p.add_argument("--refine", default="none",
                   choices=["none", "icp", "f2m", "pgo"],
                   help="trajectory refinement before fusing: "
                        "frame-to-frame ICP, frame-to-model tracking, or "
                        "tracking + loop closures + pose graph")
    p.add_argument("--config", default=None, help="config JSON file")
    _add_device(p)


def _cmd_reconstruct(args):
    from otslam_tpu_torch.core.se3 import T_FIX_GT, T_FIX_OPTICAL
    from otslam_tpu_torch.pipeline.dataset import CaptureDataset
    from otslam_tpu_torch.pipeline.reconstruct import (
        reconstruct_all, reconstruct_object, reconstruct_range)

    cfg = _load_cfg(args)
    ds = CaptureDataset(args.dataset, cfg.camera,
                        t_fix=T_FIX_GT if args.gt_poses else T_FIX_OPTICAL)
    save_dir = args.save_dir or os.path.join(args.dataset, "3d_reconst")
    kw = dict(cfg=cfg.reconstruction, backend=args.backend,
              save_dir=save_dir, z_filter=not args.no_z_filter,
              output="mesh" if args.mesh else "cloud",
              auto_origin=args.auto_origin, refine=args.refine,
              device=args.device)
    if args.ranges:
        ranges = {}
        for part in args.ranges.split(","):
            name, span = part.split(":")
            lo, hi = span.split("-")
            ranges[name] = (int(lo), int(hi))
        out = reconstruct_range(ds, ranges, **kw)
    elif args.object:
        out = {args.object: reconstruct_object(ds, args.object, **kw)}
    else:
        out = reconstruct_all(ds, **kw)
    for name, res in out.items():
        print(f"{name}: {len(res.points)} points from {res.num_frames} frames "
              f"-> {os.path.join(save_dir, name + '.ply')}")


def _cmd_eval(args):
    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.eval.scenarios import scenario_gt

    map_pts = tio.read_ply(args.map)["points"]
    if args.gt:
        gt = tio.read_ply(args.gt)["points"]
    else:
        gt = scenario_gt(args.scenario, args.gt_samples)
    m = evaluate_map(map_pts, gt, use_icp=args.icp, device=args.device)
    print(json.dumps({"accuracy_cm": round(m.accuracy_cm, 3),
                      "completeness_cm": round(m.completeness_cm, 3),
                      "icp_fitness": round(m.icp_fitness, 4)}))


def _load_cfg(args):
    from otslam_tpu_torch.config import OTSLAMConfig
    if getattr(args, "config", None):
        with open(args.config) as f:
            return OTSLAMConfig.from_json(f.read())
    return OTSLAMConfig()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m otslam_tpu_torch.cli",
                                 description="OTSLAM on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_reconstruct(sub)

    p = sub.add_parser("eval", help="accuracy/completeness vs GT")
    p.add_argument("--map", required=True)
    p.add_argument("--scenario", default="cardboard",
                   choices=["cardboard", "cone", "table_chair", "full"])
    p.add_argument("--gt", default=None, help="GT ply (overrides scenario)")
    p.add_argument("--gt-samples", type=int, default=50000)
    p.add_argument("--icp", action="store_true",
                   help="ICP-align the GT onto the map first")
    _add_device(p)

    args = ap.parse_args(argv)
    {"reconstruct": _cmd_reconstruct, "eval": _cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    main()
