"""Closed-loop batches through `evaluation/harness.py::make_transcribe_fn`.

Set-up: the seeded weights quantized as the configuration states, the
transcription function, one warm-up batch of the cell's shape (the kernel
library is built or loaded there), and the traffic's pool of batches held
in pinned host memory. The window: each batch is uploaded, transcribed and
read back (tokens and lengths) before the next is sent, until `--seconds`
have passed. `rtfx` is the audio of every batch read back inside the
window (each clip's true length) over the time from the first batch's
start to the last such batch's readback; a batch still running at the
close is not counted. With `--trace 1` the profiler covers the first
`trace.batches` batches of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import flops, program
from benchlib.outcome import Outcome, Served


def build(ctx) -> dict:
    cfg_file, wl = ctx.config, ctx.workload
    arch = program.arch_of(cfg_file)
    cfg = program.decode_config(cfg_file, ctx.new_tokens)
    program.check_prefix(cfg_file, arch, cfg)
    params = program.build_params(cfg_file, ctx.weights)
    fn = program.transcribe_fn(cfg_file, arch, cfg, ctx.device)
    pool = [torch.from_numpy(b) for b in ctx.traffic["batches"]]
    if ctx.device.type == "cuda":
        pool = [b.pin_memory() for b in pool]
    fn(params, pool[0].to(ctx.device))[1].cpu()          # warm-up: the cell's shapes
    return {"params": params, "fn": fn, "pool": pool}


def window(ctx, prog: dict) -> Outcome:
    fn, params, pool = prog["fn"], prog["params"], prog["pool"]
    durations = ctx.traffic["durations"]
    prefix = len(ctx.config["model"]["forced_prefix"])
    n_new = ctx.new_tokens
    per_req = flops.request_flops(ctx.config["model"], prefix, n_new)
    trace_batches = int(ctx.workload.get("trace", {}).get("batches", 1))
    out = Outcome()
    if ctx.tracer is not None:
        ctx.tracer.start()          # before the window: starting the profiler takes time
    ctx.window_opens()
    deadline = ctx.t_window + ctx.seconds
    batches = []
    i = 0
    while time.perf_counter() < deadline:
        k = i % len(pool)
        ts = time.perf_counter()
        tokens, lengths = fn(params, pool[k].to(ctx.device, non_blocking=True))[:2]
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        te = time.perf_counter()
        if ctx.tracer is not None and i + 1 == trace_batches:
            ctx.tracer.stop()
        batches.append((k, ts, te, tokens, lengths))
        i += 1
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()
    ctx.window_closes()
    counted = [b for b in batches if b[2] <= deadline]
    if not counted:
        raise RuntimeError(f"no batch finished inside the {ctx.seconds} s window")
    audio_s = sum(float(durations[k].sum()) for k, *_ in counted)
    out.e2e["rtfx"] = audio_s / (counted[-1][2] - counted[0][1])
    rows = len(durations[0])
    out.attempted = rows * len(counted)
    out.done = [(te, rows * per_req) for _, _, te, _, _ in counted]
    for k, _, _, tokens, lengths in counted:
        out.short += int((lengths - prefix < n_new).sum())
    out.notes.append(f"batches {len(batches)} started, {len(counted)} read back inside "
                     f"the window; {audio_s:.3f} s of audio in "
                     f"{counted[-1][2] - counted[0][1]:.4f} s; batch walls s "
                     + " ".join(f"{te - ts:.4f}" for _, ts, te, _, _ in batches))

    # the check's sample: rows drawn from the seed among the counted batches,
    # the longest clip among them
    rng = np.random.default_rng([int(ctx.seed) & (2 ** 63 - 1), 7])
    picks = rng.choice(len(counted) * rows, size=min(ctx.sample, len(counted) * rows),
                       replace=False).tolist()
    longest = int(np.argmax(durations[counted[0][0]]))
    if picks and longest not in picks:
        picks[0] = longest
    for p in picks:
        k, _, _, tokens, lengths = counted[p // rows]
        r = p % rows
        n = int(round(durations[k][r] * 16000))
        out.served.append(Served(ctx.traffic["batches"][k][r, :n],
                                 tokens[r, prefix: lengths[r]].tolist()))
    return out
