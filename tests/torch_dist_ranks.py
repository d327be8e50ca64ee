"""Process groups for the port's multi-rank CPU tests: ``spawn`` starts a
gloo world once, every rank runs the given cases in order, and each case's
result comes back from every rank.

The ranks rendezvous through a ``file://`` under the caller's temporary
directory (no TCP port, so parallel test workers cannot collide), run with
one intra-op thread, and write each case's result as soon as it is done. The
parent joins them under a deadline and kills what is left. This module
imports torch and the port only: the ranks never load JAX.
"""
from __future__ import annotations

import importlib
import os
import pickle
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, root, cases):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        for name, target, kwargs in cases:
            mod, _, fn = target.rpartition(".")
            t0 = time.perf_counter()
            try:
                out = {"ok": getattr(importlib.import_module(mod), fn)(**kwargs)}
            except Exception:   # recorded for the test to raise, then the next case
                out = {"error": traceback.format_exc()}
            out["seconds"] = time.perf_counter() - t0
            with open(os.path.join(root, f"{name}.rank{rank}.pkl"), "wb") as f:
                pickle.dump(out, f)
            dist.barrier()   # what rank 0 wrote is there for the next case
    finally:
        dist.destroy_process_group()


def spawn(world, cases, root, timeout=240.0, meanwhile=None):
    """Run ``cases`` ([(name, "module.function", kwargs)]) on ``world`` gloo
    ranks; returns {name: [rank 0's result, rank 1's, ...]} where a result
    is {"ok": value} or {"error": traceback} (a missing case: it hung or its
    rank died). ``meanwhile()``, if given, runs here while the ranks do;
    the ranks are killed if it raises."""
    os.makedirs(root, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, root, cases), daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = {}
    for name, _, _ in cases:
        res = []
        for r in range(world):
            path = os.path.join(root, f"{name}.rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    res.append(pickle.load(f))
            else:
                res.append({"error": f"rank {r} left no result for {name} "
                                     f"(exit code {procs[r].exitcode})"})
        out[name] = res
    return out


def ok(results, rank=0):
    """The case's value on ``rank``; raises with the rank's traceback."""
    res = results[rank]
    if "error" in res:
        raise AssertionError(f"rank {rank}:\n{res['error']}")
    return res["ok"]
