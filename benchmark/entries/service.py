"""Open-loop requests through `serving.py::TranscriptionService.submit`.

Set-up: the seeded weights quantized as the configuration states, the
transcription function with the configuration's switches, the service with
the workload's `service` settings (largest batch, `max_wait_ms`, wire,
pipeline), and its `warmup()`, which runs each of its buckets once. The
window: the main thread submits each request when it is due; the service's
worker thread batches, runs and answers them. A request's latency runs from
the moment it was due to the moment its future was answered, so a late
generator or a stall counts against the requests behind it; the
generator's own lateness (submit minus due) is reported on standard error.
After the close every request due inside the window is waited for, up to a
minute; one that fails or never comes counts as failed, with the longest
latency the wait allows. With `--trace 1` the profiler covers the whole
window, started before it opens.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchlib import flops, program
from benchlib.outcome import Outcome, Served

DRAIN_S = 60.0


def build(ctx) -> dict:
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.serving import TranscriptionService

    cfg_file, wl = ctx.config, ctx.workload
    arch = program.arch_of(cfg_file)
    cfg = program.decode_config(cfg_file, ctx.new_tokens)
    program.check_prefix(cfg_file, arch, cfg)
    params = program.build_params(cfg_file, ctx.weights)
    fn = program.transcribe_fn(cfg_file, arch, cfg, ctx.device)
    s = wl["service"]
    svc = TranscriptionService(params, arch, default_tokenizer(arch), cfg,
                               batch_size=int(s["batch_size"]),
                               max_wait_ms=float(s["max_wait_ms"]), transcribe_fn=fn,
                               transfer=s["transfer"], pipeline=int(s["pipeline"]),
                               device=ctx.device)
    try:
        svc.warmup()
    except BaseException:
        svc.close()
        raise
    return {"service": svc}


def close(prog: dict) -> None:
    svc = prog["service"]
    svc.close(timeout=DRAIN_S)
    if svc._worker.is_alive():
        raise RuntimeError("the service's worker thread did not end")


def p95(values: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def window(ctx, prog: dict) -> Outcome:
    svc = prog["service"]
    tr = ctx.traffic
    offsets, clips, durations = tr["offsets"], tr["clips"], tr["durations"]
    prefix = len(ctx.config["model"]["forced_prefix"])
    n_new = ctx.new_tokens
    per_req = flops.request_flops(ctx.config["model"], prefix, n_new)
    n = len(offsets)
    done_at = [math.nan] * n
    futs = []
    late = np.zeros(n)

    def answered(i):
        def cb(_f):
            done_at[i] = time.perf_counter()
        return cb

    with svc.stats._lock:
        occ0, batches0 = svc.stats.occupancy_sum, svc.stats.batches
    if ctx.tracer is not None:
        ctx.tracer.start()          # before the window: starting the profiler takes time
    ctx.window_opens()
    t0 = ctx.t_window
    for i in range(n):
        due = t0 + offsets[i]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - due
        f = svc.submit(clips[i])
        f.add_done_callback(answered(i))
        futs.append(f)
    close_at = t0 + ctx.seconds
    if time.perf_counter() < close_at:
        time.sleep(close_at - time.perf_counter())
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()
    for f in futs:
        try:
            f.exception(timeout=max(0.0, close_at + DRAIN_S - time.perf_counter()))
        except TimeoutError:
            break
    ctx.window_closes()
    with svc.stats._lock:
        occ1, batches1 = svc.stats.occupancy_sum, svc.stats.batches

    out = Outcome(attempted=n)
    lat = []
    for i, f in enumerate(futs):
        ok = f.done() and f.exception() is None and not math.isnan(done_at[i])
        if not ok:      # a miss: counted as waiting out the whole drain
            out.failed += 1
            lat.append(close_at + DRAIN_S - (t0 + offsets[i]))
            continue
        lat.append(done_at[i] - (t0 + offsets[i]))
        out.done.append((done_at[i], per_req))
    out.latencies = lat
    out.e2e["latency_p95_ms"] = p95(lat) * 1e3
    if batches1 > batches0:
        out.counters["batch_occupancy"] = (occ1 - occ0) / (batches1 - batches0)
        out.counters["batches"] = batches1 - batches0
    srt = sorted(lat)
    out.notes.append(
        f"{n} requests due in {ctx.seconds} s ({n / ctx.seconds:.2f}/s), {out.failed} "
        f"failed or unanswered; latency ms p50 {1e3 * srt[len(srt) // 2]:.2f} "
        f"p95 {out.e2e['latency_p95_ms']:.2f} max {1e3 * max(lat):.2f}; generator lateness ms "
        f"p50 {1e3 * np.median(late):.3f} p99 {1e3 * np.quantile(late, 0.99):.3f} "
        f"max {1e3 * late.max():.3f}; batches {batches1 - batches0}")

    # the check's sample: finished requests drawn from the seed, the longest
    # clip among the finished ones included
    fine = [i for i, f in enumerate(futs) if f.done() and f.exception() is None]
    rng = np.random.default_rng([int(ctx.seed) & (2 ** 63 - 1), 7])
    picks = rng.choice(len(fine), size=min(ctx.sample, len(fine)), replace=False).tolist() \
        if fine else []
    if picks:
        longest = max(range(len(fine)), key=lambda j: durations[fine[j]])
        if longest not in picks:
            picks[0] = longest
    for j in picks:
        i = fine[j]
        toks = futs[i].result()["tokens"]
        out.served.append(Served(clips[i], list(toks)))
    for i in fine:
        out.short += int(len(futs[i].result()["tokens"]) < n_new)
    return out
