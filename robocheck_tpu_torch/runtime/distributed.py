"""Multi-process runtime on `torch.distributed` (PyTorch port of
`robocheck_tpu.runtime.distributed`).

One process per rank runs the same program; `parallel.sharding` shards the
work over the ranks of the process group. ``initialize_from_env`` joins a
group launched by any scheduler that sets COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID; ``launch`` starts the ranks of one host
itself (spawned processes, never forked: a forked child inherits a CUDA
context it cannot use).

The backend is always the caller's choice. Two ranks on one GPU need
"gloo" (NCCL refuses a duplicate GPU); nothing falls back from one backend
to another.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def initialize_from_env(backend: str) -> None:
    """Join the process group described by the environment:
    COORDINATOR_ADDRESS (host:port of rank 0), NUM_PROCESSES and PROCESS_ID.
    Does nothing when they are absent or a group is already initialised.
    Every other failure (a coordinator that cannot bind, a backend this
    build of torch lacks) raises."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    nproc = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if not (coord and nproc and pid) or dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=int(nproc), rank=int(pid))


def shard_bounds(total: int, process_index: int | None = None,
                 process_count: int | None = None) -> tuple[int, int]:
    """This rank's contiguous slice [lo, hi) of a dataset of ``total`` rows,
    so that each rank reads only its own rows. The rank and world size come
    from the process group (0 and 1 without one) unless given."""
    pi = _rank() if process_index is None else process_index
    pc = _world_size() if process_count is None else process_count
    per = (total + pc - 1) // pc
    lo = min(pi * per, total)
    return lo, min(lo + per, total)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, port: int, backend: str, args, results) -> None:
    # The ranks share this host's cores; more threads than cores makes the
    # CPU ops of every rank crawl.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world_size, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world_size: int, args: tuple = (), backend: str = "gloo",
           timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one process
    group on this host (``backend``, a fresh localhost port) and return
    their results in rank order. ``fn`` must be importable (a module-level
    function) and its result picklable. Raises RuntimeError, after stopping
    every rank, if a rank fails or the ranks are not done in ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, backend, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        # Drain the queue before joining: a child cannot exit while its
        # result is still in the pipe.
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=min(5.0, max(deadline - time.monotonic(),
                                                                 0.01)))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} and no result")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks were not done in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        results.close()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with code {bad[0]}")
    return [got[r] for r in range(world_size)]
