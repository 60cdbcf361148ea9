"""Host orchestration for continuous-batching transcription.

The JAX package's `continuous.py`. `ContinuousBatcher` drives the functions
built by `models/continuous.py` (chunk / admit / rebase, with prefill
disaggregation through encode_stage / admit_from_stage) from a plain
Python loop: every `chunk` decode steps it reads back one packed snapshot,
retires finished slots, refills them from the request queue and rebases
the global window when it nears the static cache end.

A batch-synchronous server (HF `generate`, the package's
`TranscriptionService`) runs every batch as long as its longest member;
here a finished slot is re-armed within one chunk, so device steps track
the SUM of lengths, not batches x max. `wave=True` runs the same engine
batch-synchronously, the comparator that isolates the scheduling.

`overlap=True` keeps JAX's one-chunk-late retirement: each in-flight record
holds the slot-to-request map as of its dispatch and any rebase shift
applied after its snapshot. On the card the snapshot is copied into a
pinned host buffer without blocking, behind a CUDA event that `consume`
waits on. The chunk loop reads one flag a step, so the overlap hides only
the snapshot's copy; no gain is claimed for it.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from .config import DecodeConfig, WhisperArch
from .models.continuous import gen_tokens_of_row, make_cb_fns
from .models.params import DEFAULT_DEVICE, resolve_device


@dataclass
class CBStats:
    """Counters for one `transcribe_all` run."""

    requests: int = 0
    chunks: int = 0
    device_steps: int = 0          # global counter advance (lockstep steps)
    slot_steps_busy: int = 0       # steps spent on live (unfinished) slots
    slot_steps_total: int = 0      # steps x batch slots
    rebases: int = 0
    admits: int = 0
    admit_passes: int = 0          # admit calls (each encodes or copies
                                   # admit_lanes lanes)
    wall_seconds: float = 0.0
    audio_seconds: float = 0.0
    gen_tokens: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def occupancy(self) -> float:
        return (self.slot_steps_busy / self.slot_steps_total
                if self.slot_steps_total else 0.0)

    @property
    def rtfx(self) -> float:
        return (self.audio_seconds / self.wall_seconds
                if self.wall_seconds else 0.0)

    def snapshot(self) -> dict:
        return {"requests": self.requests, "chunks": self.chunks,
                "device_steps": self.device_steps,
                "occupancy": round(self.occupancy, 4),
                "rebases": self.rebases, "admits": self.admits,
                "admit_passes": self.admit_passes,
                "wall_seconds": round(self.wall_seconds, 4),
                "audio_seconds": round(self.audio_seconds, 2),
                "gen_tokens": self.gen_tokens,
                "rtfx": round(self.rtfx, 2), **self.extra}


class _Snapshot:
    """A chunk's packed sync tensor on its way to the host: on the card a
    non-blocking copy into pinned memory behind an event, elsewhere the
    tensor itself."""

    def __init__(self, sync: torch.Tensor):
        if sync.is_cuda:
            self._host = torch.empty(sync.shape, dtype=sync.dtype, pin_memory=True)
            self._host.copy_(sync, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = sync, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class ContinuousBatcher:
    """Slot-recycling transcription over a fixed pool of decode slots, on
    `device` (the card unless the caller names another; `params` must live
    there).

    Output contract: each request's token sequence is the standalone
    `greedy_decode` output for that utterance — [forced prefix + generated
    tokens (incl. final EOT)] — independent of which requests shared the
    pool (held against jitted JAX and the port's greedy by
    tests/test_torch_continuous.py).
    """

    def __init__(self, params, arch: WhisperArch,
                 cfg: DecodeConfig | None = None, batch: int = 8,
                 chunk: int = 16, admit_lanes: int = 4,
                 cache_len: int | None = None, fast_mel: bool = True,
                 fast_gelu: bool = False, merge_at: int | None = None,
                 transfer: str = "float32", overlap: bool = False,
                 stage_encode: bool = True,
                 stage_lanes: int | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.params = params
        self.arch = arch
        self.cfg = cfg or DecodeConfig()
        self.transfer = transfer
        self.overlap = overlap
        self.device = resolve_device(device)
        # prefill disaggregation: encode arrivals in `stage_lanes`-wide
        # blocks (default = the pool size) into a staging cross-KV, so
        # admits are pure row copies; costs one extra cross-KV-sized buffer
        self.stage_encode = stage_encode
        self.stage_lanes = stage_lanes or batch
        self._wav_dtype = np.int16 if transfer == "int16" else np.float32
        self.plan, self.fns = make_cb_fns(
            arch, self.cfg, batch, chunk=chunk, admit_lanes=admit_lanes,
            cache_len=cache_len, fast_mel=fast_mel, fast_gelu=fast_gelu,
            merge_at=merge_at, transfer=transfer, overlap=overlap,
            device=self.device)
        self.state = None

    # -- internals ----------------------------------------------------------

    def _pad_wav(self, wav: np.ndarray) -> np.ndarray:
        n = self.plan.n_samples
        w = np.zeros((n,), self._wav_dtype)
        if self.transfer == "int16":
            w[: min(len(wav), n)] = np.clip(wav[:n] * 32767.0,
                                            -32768, 32767).astype(np.int16)
        else:
            w[: min(len(wav), n)] = wav[:n]
        return w

    def _wire_zeros(self, rows: int) -> torch.Tensor:
        return torch.zeros((rows, self.plan.n_samples), device=self.device,
                           dtype=torch.int16 if self.transfer == "int16"
                           else torch.float32)

    def stage(self, wavs: Sequence[np.ndarray]) -> torch.Tensor:
        """Pre-pad and upload all request audio as ONE device-resident pool
        (N, n_samples), int16 under transfer="int16"; pass it to
        `transcribe_all` instead of the wav list and admits gather rows on
        the device with no per-admit host upload."""
        return torch.from_numpy(np.stack([self._pad_wav(w) for w in wavs])).to(self.device)

    def warmup(self) -> None:
        """Run every function once (init, an admit and a staged admit with
        every lane masked off, a chunk, a rebase of 0)."""
        p = self.plan
        self.state = self.fns["init"](self.params)
        slots = np.arange(p.admit_lanes, dtype=np.int32)
        mask = np.zeros((p.admit_lanes,), bool)
        caps = np.full((p.admit_lanes,), p.max_new, np.int32)
        self.state = self.fns["admit"](self.params, self.state,
                                       self._wire_zeros(p.admit_lanes), slots, mask, caps)
        if self.stage_encode:
            block = self.fns["encode_stage"](self.params,
                                             self._wire_zeros(self.stage_lanes))
            self.state = self.fns["admit_from_stage"](
                self.state, block, np.zeros((p.admit_lanes,), np.int32),
                slots, mask, caps)
        self.state, _ = self.fns["chunk"](self.params, self.state)
        self.state = self.fns["rebase"](self.state, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- main loop -----------------------------------------------------------

    def transcribe_all(self, wavs, stats: CBStats | None = None,
                       max_new: Sequence[int] | None = None,
                       wave: bool = False,
                       overlap: bool | None = None,
                       durations: Sequence[float] | None = None
                       ) -> list[np.ndarray]:
        """Run every request through the pool; returns per-request token
        sequences (prefix + generated, standalone greedy layout) in input
        order.

        max_new: optional per-request token budgets — request i generates
        at most max_new[i] tokens, exactly as standalone greedy with
        max_new_tokens=max_new[i]. wave: batch-synchronous scheduling, only
        admitting into an EMPTY pool (same kernels and caps).

        `wavs` is either a sequence of 1-D waveforms (padded and uploaded
        per admit) or the device pool returned by `stage()` (admits gather
        on the device). Under transfer="int16" a floating pool raises.
        durations: true per-request audio seconds for stats accounting
        (a staged pool's padded rows hide them; without it a staged run
        credits the full padded window and says so in `extra`)."""
        p, fns = self.plan, self.fns
        staged = wavs if not isinstance(wavs, (list, tuple)) else None
        if staged is not None:
            staged = torch.as_tensor(staged, device=self.device)
        if staged is not None and self.transfer == "int16" \
                and staged.is_floating_point():
            raise ValueError("transfer='int16' takes an int16 pool; got a "
                             f"floating {staged.dtype} one (stage() builds it)")
        eot = self.arch.eos_token_id
        caps_req = ([min(int(m), p.max_new) for m in max_new]
                    if max_new is not None else [p.max_new] * len(wavs))
        stats = stats if stats is not None else CBStats()
        stats.requests += len(wavs)
        if durations is not None:
            stats.audio_seconds += float(sum(durations))
        elif staged is not None:
            stats.audio_seconds += len(wavs) * p.n_samples / 16000.0
            stats.extra["audio_accounting"] = "padded_window"
        else:
            stats.audio_seconds += sum(len(w) for w in wavs) / 16000.0
        results: list[Any] = [None] * len(wavs)
        queue = deque(range(len(wavs)))
        slot_req: list[int | None] = [None] * p.batch
        # host mirror of each occupied slot's start (exact without overlap,
        # a lower bound with it), used ONLY to pick rebase shifts
        start_h = [0] * p.batch

        t0 = time.perf_counter()
        state = self.state if self.state is not None \
            else fns["init"](self.params)
        # the pool may carry a previous run's window position
        pos_h = state["pos"]
        prefix = np.asarray(p.prefix, np.int64)

        overlap = (self.overlap if overlap is None else overlap) and not wave
        if overlap and p.cache_len < p.max_rel + 2 * p.chunk + 1:
            raise ValueError(
                f"cache_len {p.cache_len} too small for the overlapped "
                f"loop (needs {p.max_rel + 2 * p.chunk + 1}; construct "
                "the batcher with overlap=True)")
        margin = (2 * p.chunk if overlap else p.chunk) + 1
        inflight: dict | None = None

        # host-phase wall decomposition (stats.extra): admit calls, chunk
        # calls, the snapshot readback, stage encodes
        t_admit = t_chunk = t_read = t_stage = 0.0

        # prefill disaggregation: the NEXT block of queued arrivals encoded
        # in one large-batch pass; admits copy rows out of it. FIFO
        # invariant: the block covers the queue's head, lanes consumed in order
        use_stage = self.stage_encode
        E = self.stage_lanes
        stage_block = None
        stage_reqs: list[int] = []
        stage_next = 0

        def top_up_stage() -> None:
            nonlocal stage_block, stage_reqs, stage_next, t_stage
            if not queue:
                return
            nxt = list(itertools.islice(iter(queue), E))
            ts_ = time.perf_counter()
            if staged is not None:
                idx = np.zeros((E,), np.int64)
                idx[: len(nxt)] = nxt
                wav_block = staged[torch.from_numpy(idx).to(staged.device)]
            else:
                wav_block = np.zeros((E, p.n_samples), self._wav_dtype)
                for i, r in enumerate(nxt):
                    wav_block[i] = self._pad_wav(wavs[r])
                wav_block = torch.from_numpy(wav_block).to(self.device)
            stage_block = fns["encode_stage"](self.params, wav_block)
            stage_reqs = nxt
            stage_next = 0
            stats.extra["stage_passes"] = stats.extra.get("stage_passes", 0) + 1
            t_stage += time.perf_counter() - ts_

        if use_stage:
            top_up_stage()

        def consume(rec) -> None:
            nonlocal pos_h, t_read
            tr = time.perf_counter()
            sync = rec["sync"].numpy()
            t_read += time.perf_counter() - tr
            new_pos = int(sync[0]) - rec["shift"]
            steps = new_pos - pos_h
            pos_h = new_pos
            stats.chunks += 1
            stats.device_steps += steps
            stats.slot_steps_total += steps * p.batch
            stats.slot_steps_busy += steps * rec["live"]
            finished = sync[1: 1 + p.batch].astype(bool)
            # start + tokens come from the SAME snapshot, so extraction
            # coordinates are self-consistent even across later rebases
            start = sync[1 + p.batch: 1 + 2 * p.batch]
            tokens = sync[1 + 2 * p.batch:].reshape(p.batch, p.cache_len)
            for slot, req in rec["occ"].items():
                if finished[slot] and slot_req[slot] == req:
                    gen = gen_tokens_of_row(tokens[slot], int(start[slot]),
                                            p.p_len, caps_req[req], eot)
                    results[req] = np.concatenate([prefix, gen])
                    stats.gen_tokens += int(gen.shape[0])
                    slot_req[slot] = None

        while queue or any(r is not None for r in slot_req):
            # 1) rebase if the coming chunk could run off the window (with
            # overlap the next chunk runs one un-synced chunk ahead of
            # pos_h, so the guard covers two chunks)
            if pos_h + margin >= p.cache_len:
                occupied = [start_h[i] for i in range(p.batch)
                            if slot_req[i] is not None]
                shift = min(occupied) if occupied else pos_h
                if shift > 0:
                    state = fns["rebase"](state, shift)
                    pos_h -= shift
                    for i in range(p.batch):
                        start_h[i] = max(start_h[i] - shift, 0)
                    if inflight is not None:
                        inflight["shift"] += shift
                    stats.rebases += 1

            # 2) admit arrivals into free slots, A lanes a pass, until the
            # pool is full or the queue empties; an unstaged pass is taken
            # only when it fills at least half its lanes (or the queue
            # tail). Wave mode only refills an EMPTY pool.
            free = [i for i in range(p.batch) if slot_req[i] is None]
            if wave:
                admit_ok = len(free) == p.batch
            admit_min = 1 if use_stage else max(1, p.admit_lanes // 2)
            while queue and free and (
                    admit_ok if wave
                    else (min(len(free), len(queue))
                          >= min(admit_min, len(queue)))):
                if use_stage and stage_next >= len(stage_reqs):
                    top_up_stage()
                if staged is None and not use_stage:
                    batch_wavs = np.zeros((p.admit_lanes, p.n_samples),
                                          self._wav_dtype)
                lane_reqs = np.zeros((p.admit_lanes,), np.int64)
                lanes = np.zeros((p.admit_lanes,), np.int64)  # stage rows
                slots = np.zeros((p.admit_lanes,), np.int64)
                mask = np.zeros((p.admit_lanes,), bool)
                caps = np.full((p.admit_lanes,), p.max_new, np.int32)
                n_real = 0
                for lane in range(min(p.admit_lanes, len(free))):
                    if not queue:
                        break
                    if use_stage and stage_next >= len(stage_reqs):
                        break  # queue head not yet staged
                    req = queue.popleft()
                    slot = free[lane]
                    if use_stage:
                        # FIFO invariant: block lanes mirror queue order
                        assert req == stage_reqs[stage_next]
                        lanes[lane] = stage_next
                        stage_next += 1
                    elif staged is None:
                        batch_wavs[lane] = self._pad_wav(wavs[req])
                    lane_reqs[lane] = req
                    slots[lane] = slot
                    mask[lane] = True
                    caps[lane] = caps_req[req]
                    slot_req[slot] = req
                    start_h[slot] = pos_h
                    stats.admits += 1
                    n_real += 1
                if n_real == 0:
                    break
                # padding lanes target DISTINCT unused slots (they write
                # nothing, but the JAX scatter needs distinct rows and the
                # lane layout stays the same)
                taken = set(slots[:n_real].tolist())
                others = (i for i in range(p.batch) if i not in taken)
                for lane in range(n_real, p.admit_lanes):
                    slots[lane] = next(others)
                ta = time.perf_counter()
                if use_stage:
                    state = fns["admit_from_stage"](state, stage_block, lanes,
                                                    slots, mask, caps)
                else:
                    wav_arg = (staged[torch.from_numpy(lane_reqs).to(staged.device)]
                               if staged is not None
                               else torch.from_numpy(batch_wavs).to(self.device))
                    state = fns["admit"](self.params, state, wav_arg, slots, mask, caps)
                t_admit += time.perf_counter() - ta
                stats.admit_passes += 1
                free = [i for i in range(p.batch) if slot_req[i] is None]
                if use_stage and stage_next >= len(stage_reqs):
                    top_up_stage()

            # 3) one chunk of lockstep decode steps; only the fresh sync
            # snapshot survives for the (possibly deferred) readback
            tc = time.perf_counter()
            state, sync = fns["chunk"](self.params, state)
            rec = {"sync": _Snapshot(sync),
                   "live": sum(r is not None for r in slot_req),
                   "occ": {i: r for i, r in enumerate(slot_req)
                           if r is not None},
                   "shift": 0}
            t_chunk += time.perf_counter() - tc

            # 4) consume a snapshot: retire finished slots from ONE packed
            # readback; overlap mode consumes the PREVIOUS chunk's
            if overlap:
                if inflight is not None:
                    consume(inflight)
                inflight = rec
            else:
                consume(rec)

        self.state = state
        stats.wall_seconds += time.perf_counter() - t0
        stats.extra["t_admit_s"] = round(
            stats.extra.get("t_admit_s", 0.0) + t_admit, 4)
        stats.extra["t_chunk_dispatch_s"] = round(
            stats.extra.get("t_chunk_dispatch_s", 0.0) + t_chunk, 4)
        stats.extra["t_readback_s"] = round(
            stats.extra.get("t_readback_s", 0.0) + t_read, 4)
        if use_stage:
            stats.extra["t_stage_s"] = round(
                stats.extra.get("t_stage_s", 0.0) + t_stage, 4)
        return results
