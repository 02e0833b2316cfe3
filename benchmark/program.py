"""What the program records of itself in a traced recon run: each object's
`timings["trace"]` from reconstruct_frames(timings=) (otslam_tpu_torch/
utils/profiling.py), which holds its spans ([name, parent, t0_ns, t1_ns])
and the change of each process counter over the call.

A program that records nothing (no "trace" in its timings) gives None, so
a reader of these records reports nothing there and never raises.
"""

from __future__ import annotations


def records(ctx) -> list:
    """The traced window's per-object records, in order."""
    return [t["trace"] for t in ctx.get("stages", [])
            if isinstance(t.get("trace"), dict)]


def span_ms(ctx, *names):
    """Mean per object of the summed ms of its spans named in `names`,
    over the objects that have one; None if none has."""
    per = []
    for rec in records(ctx):
        ns = [s[3] - s[2] for s in rec.get("spans", []) if s[0] in names]
        if ns:
            per.append(1e-6 * sum(ns))
    return sum(per) / len(per) if per else None


def count_mean(ctx, name: str):
    """Mean per object of the counter `name`'s change (0 where it did not
    move), over the objects with a record; None if none has one."""
    recs = records(ctx)
    if not recs:
        return None
    return sum(r.get("counts", {}).get(name, 0) for r in recs) / len(recs)
