"""Run a function on N ranks of a `torch.distributed` process group.

    results = run_ranks(fn, args, world=4, backend="gloo", timeout=120)

Starts `world` processes with the spawn context, each joining a group
through a FileStore in a fresh temporary directory (no TCP port to collide
on), with one intra-op thread each; every rank calls fn(*args) and its
return value comes back through a pickle file. A rank that raises fails
the call with that rank's traceback; a group that outlives `timeout`
seconds is killed and fails the call. `fn` must be importable by module
path (spawn pickles it by name).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(fn, args, rank: int, world: int, backend: str, store: str,
               out: str, timeout: float) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, args=(), world: int = 2, backend: str = "gloo",
              timeout: float = 120.0) -> list:
    """[fn(*args) on rank r for r in range(world)]; raises RuntimeError
    when a rank fails and TimeoutError when the group outlives
    `timeout` seconds (its processes are killed either way)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world, backend, store,
                                   outs[r], timeout), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while not all(p.exitcode == 0 for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = Path(outs[r] + ".err")
                    why = (err.read_text() if err.exists()
                           else f"exit code {procs[r].exitcode}")
                    raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results
