"""Profiling and analytic cost tools.

The port's counterpart of the JAX package's `utils/profiling.py`:
`torch.profiler` trace capture (a Chrome trace), a per-call cost count
under XLA's key names (`flops`, `bytes accessed`, and `transcendentals`
where a hand-written kernel launched), and a timing harness that times the
card with CUDA events and the CPU with `perf_counter`.

XLA's cost model also reports `optimal_seconds` and per-operand byte
counts; nothing here computes those, so they are absent, never 0.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a `torch.profiler` trace (CPU, plus CUDA where torch sees a
    card) of the block and write it as `<log_dir>/trace.json`, viewable in
    chrome://tracing or Perfetto. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(tree: Any, out: dict) -> None:
    """Every tensor reachable from `tree` (dicts, lists, tuples, dataclasses
    such as QTensor), keyed by storage so a shared buffer counts once."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        out[(tree.device, tree.untyped_storage().data_ptr())] = \
            tree.untyped_storage().nbytes()
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)


def _bmm_flop(a_shape, b_shape, out_dtype=None, *, out_shape=None, **kw) -> int:
    """FLOPs of `aten.bmm`, its `dtype` overload too (a bf16 batched product
    with an f32 output, which `ops.attention.matmul_f32` takes on the card):
    `FlopCounterMode`'s own formula takes that overload's third argument for
    the output shape and fails."""
    b, n, k = a_shape
    return 2 * b * n * k * b_shape[-1]


def cost_analysis(fn: Callable, *args: Any) -> dict[str, float]:
    """Cost of one call `fn(*args)`, under XLA's key names:

    - `flops`: what `torch.utils.flop_counter.FlopCounterMode` counts, the
      matmuls, convolutions and attention of the call's aten ops (2 per
      multiply-add; XLA also counts elementwise work, so this is lower),
      plus what every hand-written kernel the call launched declares;
    - `bytes accessed`: the bytes of every tensor the call reads (its
      arguments, QTensor fields included) and writes (its outputs), each
      buffer once, plus what every launched kernel declares it moves (as
      XLA sums each op's operands, a buffer a kernel reads is counted again);
    - `transcendentals`, where a kernel launched: what the kernels declare.

    A kernel declares, at each launch, the cost that the JAX package's
    Pallas kernel declares in its `pl.CostEstimate` for the same call, with
    JAX's padded extents (`kernels.record_cost`): XLA's cost model reports
    just those numbers for the Mosaic call that JAX's `cost_analysis`
    reads. A CPU call takes the plain versions, whose work is aten ops."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import kernels

    before = dict(kernels.COSTS)
    with FlopCounterMode(display=False,
                         custom_mapping={torch.ops.aten.bmm: _bmm_flop}) as counter:
        out = fn(*args)
    kernel = {k: kernels.COSTS[k] - before[k] for k in before}
    seen: dict = {}
    _tensors(args, seen)
    read = sum(seen.values())
    _tensors(out, seen)
    written = sum(seen.values()) - read
    res = {"flops": float(counter.get_total_flops()) + kernel["flops"],
           "bytes accessed": float(read + written) + kernel["bytes accessed"]}
    if any(kernel.values()):
        res["transcendentals"] = kernel["transcendentals"]
    return res


def _on_card(args: Any) -> bool:
    seen: dict = {}
    _tensors(args, seen)
    return any(dev.type == "cuda" for dev, _ in seen)


def timed(fn: Callable, *args: Any, iters: int = 3,
          warmup: int = 1) -> dict[str, float]:
    """Median time of fn(*args) after `warmup` calls: CUDA events around
    each call where an argument lives on the card, `perf_counter` where all
    live on the CPU."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    times = []
    if _on_card(args):
        torch.cuda.synchronize()
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(*args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0],
            "max_s": times[-1], "iters": iters}


def flops_per_second(fn: Callable, *args: Any, iters: int = 3) -> dict[str, float]:
    """Achieved FLOP/s = counted flops (the kernels' declared ones included)
    / measured median time. Where the count saw no FLOPs,
    `achieved_tflops` is None rather than a made-up rate."""
    costs = cost_analysis(fn, *args)
    t = timed(fn, *args, iters=iters)
    fl = costs["flops"]
    return {**t, "model_flops": fl,
            "achieved_tflops": fl / t["median_s"] / 1e12 if fl > 0 else None,
            "bytes_accessed": costs["bytes accessed"]}
