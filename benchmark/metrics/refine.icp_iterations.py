"""refine.icp_iterations: the program's `icp.iterations` counter (each ICP
call's iterations, kernels/icp.py) over one reconstruct_frames call, mean
per object of the traced window; None where no object's record holds it."""

from benchmark.program import records


def read(ctx):
    recs = records(ctx)
    its = [r.get("counts", {}).get("icp.iterations") for r in recs]
    if not any(v is not None for v in its):
        return None
    return sum(v or 0 for v in its) / len(recs)
