"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads BENCHMARK.json, the cell's configuration and traffic files, makes
its inputs from the seed, warms up, runs the measured window, judges the
window's answers against the plain reference and prints the result as the
last line of standard output (the numbers compared, with their limits, as
the last lines of standard error too). `--trace 1` reports the per-layer
metrics instead of the end-to-end ones. `--control 1` also computes the
control (the reference in bfloat16 in the program's place) and prints its
readings on standard error; it is for setting limits, not for the cells'
runs.

Exit codes: 0 a result was printed (correct or not); 2 the checkout lacks
a file the cell needs, or the program; 3 no CUDA device, or fewer than the
cell asks for; 4 a JAX module or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's BLAS and OpenMP pools stay at
# one thread, set before numpy or torch is imported
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, root=None, t_start=None) -> int:
    """Run a cell; `device` other than None skips the look for a card (the
    benchmark's own tests drive the CPU this way)."""
    args = parse(argv)
    t_start = T_START if t_start is None else t_start
    from benchmark import harness
    root = Path(root or os.getcwd())
    try:
        spec = harness.load_spec(root)
        base = root / "benchmark"
        entry, cfg, traffic = harness.cell_files(spec, args.workload, base)
        drv = harness.driver(traffic["driver"])
        import torch
        import otslam_tpu_torch  # noqa: F401  (the program under test)
    except (OSError, KeyError, ImportError) as e:
        print(f"benchmark: cannot start: {e!r}", file=sys.stderr)
        return 2
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < entry["chips"]):
            print(f"benchmark: needs {entry['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = "cuda:0"
    device = torch.device(device)
    torch.set_num_threads(1)
    gc.collect()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx = drv.run(cfg=cfg, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=device, chips=entry["chips"], t_start=t_start,
                  control=bool(args.control))

    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 4
    metrics = {}
    for m in harness.metrics_for(spec, args.workload, bool(args.trace)):
        v = harness.reader(m["name"], base)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = ctx["checks"]
    dev = dict(ctx["device"])
    result = {"correct": bool(checks.correct() and ctx["failed"] == 0),
              "attempted": int(ctx["attempted"]),
              "failed": int(ctx["failed"]),
              "metrics": metrics, "device": dev}
    if args.trace:
        tr = ctx.get("trace")
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    if ctx.get("control") is not None:
        ctl = ctx["control"]
        print("control: " + json.dumps({"correct": ctl.correct(),
                                        "checks": ctl.record()}),
              file=sys.stderr)
    for name, rec in checks.record().items():
        print(f"check {name}: {json.dumps(rec)}", file=sys.stderr)
    result["checks"] = checks.record()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
