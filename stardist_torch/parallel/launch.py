"""Run a function on several ranks of a fresh process group.

:func:`run_ranks` starts ``world_size`` processes with multiprocessing's
``spawn`` method, joins them in a ``torch.distributed`` process group through
a ``file://`` rendezvous in a new temporary directory (no port to pick), and
calls ``fn(rank, world_size, *args)`` in each. It returns the ranks' results
in rank order, or raises as soon as one rank fails or the time runs out,
after killing every rank: a rank's failure is never caught and dropped, and
nothing is left running.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(fn, args, rank, world_size, backend, init_file, timeout, threads, results):
    import torch
    import torch.distributed as dist
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: multiprocessing's own would hand a tensor over through
        # shared memory, which this process takes with it when it exits
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size, args=(), *, backend="gloo", timeout=120.0, threads=None,
              tmp_dir=None):
    """``[fn(rank, world_size, *args) for each rank]``, each call in its own
    process, all joined in one process group of ``backend``.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and so is
    each result. ``timeout`` (seconds) bounds the whole run and each
    collective; ``threads`` sets each rank's torch CPU threads;
    ``tmp_dir`` holds the rendezvous (a new temporary directory, removed
    afterwards). Raises ``RuntimeError`` with the traceback of the first
    rank that fails or exits without a result, and ``TimeoutError`` when
    the ranks are not done in time."""
    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="ranks_", dir=tmp_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world_size, backend,
                               os.path.join(work, "rendezvous"), timeout, threads, results),
                         daemon=True)
             for r in range(world_size)]
    done = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size - len(done)} of {world_size} ranks not done "
                                   f"after {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    # a result may still be in the pipe: look once more before failing
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
            done[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        results.join_thread()
        shutil.rmtree(work, ignore_errors=True)
