"""A pool of gloo ranks for the port's multi-device tests.

Each test file that needs ranks starts one pool (a module-scoped fixture):
``world`` spawned processes that join a gloo world on a file store, then
wait for tasks.  A task is a function of ``tests/torch_dist_tasks.py``
named by string, run by every rank with the same arguments (numpy arrays
and plain values), in the order the tasks were sent, so every rank makes
the same process groups and collectives in the same order.  The pool
returns each rank's result.  The ranks import torch and the port; the tasks
that replay JAX's draws import JAX on the CPU too (``torch_dist_tasks.jax_cpu``).

A rank that raises sends back its traceback; a task that outlives
``timeout`` seconds (a rank left waiting in a collective its peers never
join) kills the pool, and the next task starts a new one.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback
from datetime import timedelta


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(rank: int, world: int, store: str, inq, outq) -> None:
    import sys

    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    os.environ["JAX_PLATFORMS"] = "cpu"  # the tasks that replay JAX's draws
    import torch
    import torch.distributed as dist

    import torch_dist_tasks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    while True:
        task = inq.get()
        if task is None:
            break
        tid, name, args, kwargs = task
        try:
            outq.put((tid, rank, True, getattr(torch_dist_tasks, name)(*args, **kwargs)))
        except Exception:  # the traceback goes back to the test
            outq.put((tid, rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 4, timeout: float = 240.0):
        self.world, self.timeout = world, timeout
        self.procs = None
        self.tid = 0

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="gogp_dist_")
        store = os.path.join(self.dir, "store")
        self.inqs = [ctx.Queue() for _ in range(self.world)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, args=(r, self.world, store, self.inqs[r], self.outq), daemon=True)
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, **kwargs) -> list:
        """Every rank's result of ``torch_dist_tasks.<name>(*args, **kwargs)``,
        in rank order."""
        if self.procs is None:
            self._start()
        self.tid += 1
        for q in self.inqs:
            q.put((self.tid, name, args, kwargs))
        results, errors = {}, []
        waited = 0.0
        while len(results) + len(errors) < self.world:
            try:
                tid, rank, ok, out = self.outq.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                if dead or waited > self.timeout:
                    self.close(kill=True)
                    raise TimeoutError(f"{name}: ranks {sorted(set(range(self.world)) - set(results))} did not "
                                       f"answer (dead ranks {dead}, {waited:.0f} s)")
                continue
            if tid != self.tid:
                continue
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            self.close(kill=True)
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        if self.procs is None:
            return
        for p, q in zip(self.procs, self.inqs):
            if kill:
                p.kill()
            else:
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        self.procs = None
        shutil.rmtree(self.dir, ignore_errors=True)
