"""The ranks of a cell that runs over several cards: one process a card,
as ``torchrun`` would start them.

The process that ``rtbench/run.py`` started is rank 0: it prints the
result, and its clock is the run's.  A :class:`World` starts ranks
1..N-1 (the ``spawn`` start method) with torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT`` on a free local port, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``); each of them runs :func:`rank_main`:
the same set-up, window and profiled units as rank 0, whose collectives
meet rank 0's inside the program, then a report gathered to rank 0.  A
rank joins the program's world itself (``rt_tpu_torch.dist.initialize``
in the generator's set-up).

Nothing may hang.  Rank 0 watches its ranks: one that ends with another
code than 0 before it is joined ends the run at once (exit code 4, no
result).  A rank watches rank 0 and ends when rank 0 has gone.  A rank
that stops answering fails the others' collectives after the program's
timeout (60 s), and rank 0's failure ends the rest.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

RANK_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
            "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank)}


def pin(rank: int, world: int):
    """Keep this process on its own slice of the cores the run may use, so
    that the ranks' host threads do not take turns on one core."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= world:
        per = len(cores) // world
        os.sched_setaffinity(0, cores[rank * per:(rank + 1) * per])


def _watch_parent(parent: int):
    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        print("rtbench: rank 0 has gone; this rank ends", file=sys.stderr, flush=True)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def rank_main(rank: int, world: int, port: int, parent: int, argv: list, root: str,
              device: str):
    """Rank ``rank`` of a run (``argv`` as ``run.py`` got it): set-up,
    window, the profiled units under the profiler, and the report that
    rank 0 gathers; it prints no result."""
    from pathlib import Path

    # standard output carries rank 0's result alone
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    _watch_parent(parent)
    os.environ.update(rank_env(rank, world, port))
    pin(rank, world)

    import torch

    from . import core, devtrace
    from .drive import GENERATORS

    args = core.parse(argv)
    _, _, config, traffic = core.load_cell(Path(root), args.workload)
    gen = GENERATORS[traffic["kind"]](config, traffic, args.seed, torch.device(device))
    gen.setup()
    gen.count_window(args.seconds)
    gen.window(args.seconds)
    on_card = gen.device.type == "cuda"
    trace = None
    if args.trace:
        k = traffic["profile_units"]
        if on_card:
            trace, _ = devtrace.profile(lambda: gen.profiled(k), gen.device, gen.meet)
        else:
            gen.profiled(k)
    peak = torch.cuda.max_memory_allocated(gen.device) if on_card else 0
    gen.reports(peak, trace)
    gen.release()


class World:
    """Ranks 1..N-1 of a run, started by rank 0."""

    def __init__(self, world: int, argv: list, root, device: str, entry=None):
        import multiprocessing

        self.size = world
        port = _free_port()
        self._saved = {k: os.environ.get(k) for k in RANK_VARS}
        ctx = multiprocessing.get_context("spawn")
        entry = rank_main if entry is None else entry
        self.procs = [ctx.Process(target=entry, daemon=True,
                                  args=(r, world, port, os.getpid(), list(argv), str(root),
                                        device))
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        os.environ.update(rank_env(0, world, port))
        self._cores = os.sched_getaffinity(0)
        pin(0, world)
        self._joined = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self._joined.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode not in (None, 0):
                    print(f"rtbench: rank {r} ended with exit code {p.exitcode}; the run ends "
                          "without a result", file=sys.stderr, flush=True)
                    self._stop()
                    os._exit(4)

    def _stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10.0)

    def join(self, timeout: float = 60.0) -> bool:
        """Wait for every rank to end; whether each ended with code 0."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        ok = all(p.exitcode == 0 for p in self.procs)
        self._joined.set()
        return ok

    def close(self):
        """Stop what is left of the ranks and give back the environment and
        the cores."""
        self._joined.set()
        self._stop()
        os.sched_setaffinity(0, self._cores)
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
