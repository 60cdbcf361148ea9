"""Process-group initialization, and a launcher of local worlds.

The JAX package's `parallel/multihost.py` initializes `jax.distributed` so
that one program spans hosts. Here `initialize` starts `torch.distributed`
from a coordinator address or from the environment torchrun sets
(MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK), with NCCL on the card and
gloo on the CPU; nothing is discovered from a cluster.

`run_world` starts a world of processes on this host (tests, the two-rank
group on one card) and gathers what each rank's function returns.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Callable

DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               init_method: str | None = None) -> dict:
    """Initialize the default process group from the arguments or the
    environment (coordinator "host:port" or MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE, RANK; `init_method`, e.g. "file:///path", instead of a
    coordinator). No-op for one process without a coordinator.
    backend: "nccl" where torch sees a card, else "gloo", unless given.
    Every collective of the group fails after `timeout_s` instead of
    hanging."""
    import torch
    import torch.distributed as dist

    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None and init_method is None:
        return {"initialized": False, "processes": 1, "process_id": 0,
                "devices": torch.cuda.device_count()}
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend,
                                init_method=init_method or f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timedelta(seconds=timeout_s))
    return {"initialized": True, "processes": dist.get_world_size(),
            "process_id": dist.get_rank(), "backend": dist.get_backend(),
            "devices": torch.cuda.device_count()}


def _child(rank: int, world: int, store: str, backend: str, timeout_s: float,
           threads: int, fn: Callable, payload: bytes, queue) -> None:
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        initialize(None, world, rank, backend, timeout_s, init_method=store)
        queue.put((rank, True, pickle.dumps(fn(*pickle.loads(payload)))))
    except BaseException:                       # the parent raises it
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, *args: Any, backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S, threads: int = 1) -> list:
    """Run fn(*args) on every rank of a fresh world of `world_size` spawned
    processes (rendezvous through a file store in a fresh temporary
    directory, so worlds that run at once never meet; `torch.set_num_threads
    (threads)` in each) and return the ranks' results in rank order. `fn`
    must be importable by name and its results picklable (CPU tensors,
    numpy). A rank that raises, or a world that has not finished within
    `timeout_s` (every collective also times out after it), raises here;
    every process is ended before this returns. Arguments and results
    travel as plain pickles (a tensor's bytes inline), which is much
    quicker than multiprocessing's shared-memory handles for many small
    tensors."""
    import multiprocessing as mp
    import pickle
    import queue as queue_mod
    import shutil
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="owc-world-")
    store = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world_size, store, backend, timeout_s, threads,
                               fn, pickle.dumps(args), q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s + 30.0
    try:
        while len(results) < world_size:
            try:
                rank, ok, res = q.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise TimeoutError(
                    f"world of {world_size}: ranks {sorted(set(range(world_size)) - set(results))} "
                    f"gave nothing within {timeout_s + 30.0:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{res}")
            results[rank] = pickle.loads(res)
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
