"""Profiling and analytic cost tools.

The port's counterpart of the JAX package's `utils/profiling.py`:
`torch.profiler` trace capture (a Chrome trace), a per-call cost count
under XLA's key names (`flops`, `bytes accessed`), and a timing harness that
times the card with CUDA events and the CPU with `perf_counter`.

XLA's cost model also reports `transcendentals`, `optimal_seconds` and
per-operand byte counts; nothing here computes those, so they are absent,
never 0.
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


def _kernel_launches() -> int:
    """Launches of the port's hand-written kernels so far (every counter
    attribute of every wrapper)."""
    from ..audio import mel_kernel
    from ..ops import attention, cross_attention, quant_matmul, self_attention_step

    fns = [mel_kernel.log_mel_cuda, attention.encoder_attention,
           cross_attention.transpose_quant_kv,
           cross_attention.decode_cross_attention,
           cross_attention.decode_cross_attention_grouped,
           quant_matmul.int8_matmul, quant_matmul.int4_matmul,
           quant_matmul.nf4_matmul, quant_matmul.group_asym_matmul,
           quant_matmul.w8a8_matmul,
           self_attention_step.decode_self_attention_update,
           self_attention_step.decode_self_attention_update_int8,
           self_attention_step.decode_self_attention]
    return sum(v for f in fns for k, v in vars(f).items()
               if k.startswith("launches") and isinstance(v, int))


def cost_analysis(fn: Callable, *args: Any) -> dict[str, float]:
    """Cost of one call `fn(*args)`, under XLA's key names:

    - `flops`: what `torch.utils.flop_counter.FlopCounterMode` counts, the
      matmuls, convolutions and attention of the call's aten ops (2 per
      multiply-add; XLA also counts elementwise work, so this is lower);
    - `bytes accessed`: the bytes of every tensor the call reads (its
      arguments, QTensor fields included) and writes (its outputs), each
      buffer once.

    A hand-written kernel's launch is not an aten op, so its FLOPs are not
    counted: where the call launched any, `uncounted_kernel_launches` says
    how many (a CPU call never does; it takes the plain versions)."""
    from torch.utils.flop_counter import FlopCounterMode

    before = _kernel_launches()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    launched = _kernel_launches() - before
    seen: dict = {}
    _tensors(args, seen)
    read = sum(seen.values())
    _tensors(out, seen)
    written = sum(seen.values()) - read
    res = {"flops": float(counter.get_total_flops()),
           "bytes accessed": float(read + written)}
    if launched:
        res["uncounted_kernel_launches"] = float(launched)
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
    """Achieved FLOP/s = counted flops / measured median time. Where the
    count saw no FLOPs (or the call launched kernels it cannot see),
    `achieved_tflops` is None rather than a made-up rate."""
    costs = cost_analysis(fn, *args)
    t = timed(fn, *args, iters=iters)
    fl = costs["flops"]
    ok = fl > 0 and "uncounted_kernel_launches" not in costs
    return {**t, "model_flops": fl,
            "achieved_tflops": fl / t["median_s"] / 1e12 if ok else None,
            "bytes_accessed": costs["bytes accessed"],
            **({"uncounted_kernel_launches": costs["uncounted_kernel_launches"]}
               if "uncounted_kernel_launches" in costs else {})}
