"""Dynamic-batching transcription service.

The JAX package's `serving.py`: a long-lived process with a batcher in
front of the transcription function.

- requests (`submit`, `submit_flac`) land in a queue; one worker thread
  assembles them into batches with the native C++ `BatchLoader`
  (runtime/src/owc_runtime.cpp: threaded resample/pad/trim, FLAC decoding
  in its worker pool, per-slot decode-failure flags);
- a batch launches when full or after `max_wait_ms`, whichever comes first,
  on the smallest bucket (batch_size // 4, // 2, batch_size) that holds it;
- the audio crosses to the device as float32, int16 PCM (x 1/32768 on the
  device) or G.711 mu-law bytes (expanded on the device);
- per-request futures deliver {"text", "tokens", "audio_seconds",
  "latency_s"}; audio longer than one window is split into windows that
  ride the batcher as independent items and are reassembled in order.

All device work stays on the worker thread, under inference mode there
(`torch.inference_mode` is thread-local), on that thread's current stream,
where the kernels launch (`ops.kernels.stream_of`). Everything runs on
`device` (the card unless the caller names another; `params` must live
there).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from .config import DecodeConfig, WhisperArch
from .models.params import DEFAULT_DEVICE, resolve_device

_MU = 255.0  # G.711 u-law companding constant
_MULAW_LUT: np.ndarray | None = None  # int16 -> uint8 code table
PCM16_WIRE_SCALE = 1.0 / 32768.0      # the int16 wire, as `_pcm16` quantizes


def _mulaw_lut() -> np.ndarray:
    global _MULAW_LUT
    if _MULAW_LUT is None:
        x = np.arange(-32768, 32768, dtype=np.float32) / 32768.0
        y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
        _MULAW_LUT = np.round((y + 1.0) * 127.5).astype(np.uint8)
    return _MULAW_LUT


def _pcm16(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> int16 PCM (the quantization both wire codecs
    share: int16 sends these samples, u-law looks them up)."""
    return np.clip(np.round(np.asarray(x) * 32768.0), -32768,
                   32767).astype(np.int16)


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> uint8 u-law code (1 B/sample wire format): int16
    PCM, then one table gather."""
    return _mulaw_lut()[_pcm16(x).astype(np.int32) + 32768]


def mulaw_decode(u: torch.Tensor) -> torch.Tensor:
    """uint8 u-law code -> float32 [-1, 1], in torch on `u`'s device, so
    only 1 B/sample crosses the host-device link."""
    y = u.to(torch.float32) * (1.0 / 127.5) - 1.0
    return torch.sign(y) * (torch.pow(1.0 + _MU, y.abs()) - 1.0) / _MU


class _FlacRequest:
    """A queued utterance still in FLAC form: the bytes travel to the
    native BatchLoader, which decodes them in its worker pool. `__len__` is
    the per-channel sample count, for the worker's duration accounting."""

    __slots__ = ("data", "samples")

    def __init__(self, data: bytes, samples: int):
        self.data = data
        self.samples = samples

    def __len__(self) -> int:
        return self.samples


@dataclass
class ServiceStats:
    requests: int = 0        # batch items processed (chunk windows count)
    user_requests: int = 0   # user-facing submissions (chunked = 1)
    batches: int = 0
    occupancy_sum: float = 0.0
    audio_seconds: float = 0.0
    busy_seconds: float = 0.0
    queue_peak: int = 0
    # submit->result latencies (seconds), at most MAX_LATENCIES kept
    latencies: list = field(default_factory=list, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    MAX_LATENCIES = 10_000

    def snapshot(self) -> dict:
        with self._lock:
            mean_occ = (self.occupancy_sum / self.batches
                        if self.batches else 0.0)
            rtfx = (self.audio_seconds / self.busy_seconds
                    if self.busy_seconds else 0.0)
            lat = {}
            if self.latencies:
                arr = np.asarray(self.latencies)
                lat = {"latency_p50_ms": float(np.percentile(arr, 50)) * 1e3,
                       "latency_p95_ms": float(np.percentile(arr, 95)) * 1e3,
                       "latency_max_ms": float(arr.max()) * 1e3}
            return {
                "requests": self.requests,
                "user_requests": self.user_requests,
                "batches": self.batches,
                "mean_batch_occupancy": mean_occ,
                "audio_seconds": self.audio_seconds,
                "busy_seconds": self.busy_seconds,
                "rtfx": rtfx,
                "queue_peak": self.queue_peak,
                **lat,
            }


class TranscriptionService:
    """Dynamic-batching front end over a transcribe function.

    params/arch: model to serve (params on `device`). tokenizer:
    .decode(ids)->str. batch_size: the largest batch (buckets at // 4, // 2
    and itself). max_wait_ms: max time the first request in a batch waits
    for co-riders. transcribe_fn: fn(params, wav (B, n) f32 on the device)
    -> (tokens, lengths), `make_transcribe_fn(arch, cfg)` by default.
    transfer: "float32", "int16" (PCM, x 1/32768 on the device) or "mulaw"
    (lossy, opt-in). pipeline: batches in flight (1 = fenced).
    """

    def __init__(self, params, arch: WhisperArch, tokenizer,
                 cfg: DecodeConfig | None = None, batch_size: int = 8,
                 max_wait_ms: float = 50.0, transcribe_fn=None,
                 transfer_int16: bool = False,
                 transfer: str | None = None,
                 pipeline: int = 2,
                 device: str | torch.device = DEFAULT_DEVICE):
        from .evaluation.harness import make_transcribe_fn, samples_for_arch
        from .models.decode import forced_prefix
        from .runtime_native import BatchLoader

        self.device = resolve_device(device)
        self.params = params
        self.arch = arch
        self.tokenizer = tokenizer
        self.cfg = cfg or DecodeConfig()
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self.n_samples = samples_for_arch(arch)
        self.transfer = transfer or ("int16" if transfer_int16 else "float32")
        if self.transfer not in ("float32", "int16", "mulaw"):
            raise ValueError(f"transfer must be float32|int16|mulaw, "
                             f"got {self.transfer!r}")
        self.transfer_int16 = self.transfer == "int16"
        base_fn = transcribe_fn or make_transcribe_fn(arch, self.cfg,
                                                      device=self.device)
        decode = {"float32": lambda w: w.to(torch.float32),
                  "int16": lambda w: w.to(torch.float32) * PCM16_WIRE_SCALE,
                  "mulaw": mulaw_decode}[self.transfer]

        @torch.inference_mode()
        def _fn_wire(params, wire):
            if isinstance(wire, np.ndarray):
                wire = torch.from_numpy(wire)
            return base_fn(params, decode(wire.to(self.device)))

        self._fn = _fn_wire
        self._first_gen = len(forced_prefix(arch, self.cfg))
        # batches in flight: 2 = prepare batch i+1 (loader, wire encode,
        # upload) while batch i's results are outstanding; 1 = fenced
        self.pipeline = max(1, int(pipeline))
        # bucketed dispatch: a partial batch runs the smallest bucket that
        # holds it instead of padding to batch_size
        self.buckets = tuple(sorted({max(1, batch_size // 4),
                                     max(1, batch_size // 2), batch_size}))
        self._busy_mark = 0.0  # merged-interval busy accounting
        self._loader = BatchLoader(batch_size, self.n_samples)
        self._queue: queue.Queue = queue.Queue()
        self.stats = ServiceStats()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API
    def warmup(self) -> None:
        """Run every bucket once before serving traffic (its first batch
        otherwise pays its set-up inside a request's latency)."""
        dt = {"int16": np.int16, "mulaw": np.uint8}.get(self.transfer, np.float32)
        for b in self.buckets:
            self._fn(self.params, np.zeros((b, self.n_samples), dt))[0].cpu()

    def submit(self, wav: np.ndarray, sample_rate: int = 16000) -> Future:
        """Enqueue one utterance; resolves to
        {"text", "tokens", "audio_seconds", "latency_s"}.

        Audio longer than one 30 s window is split into fixed windows that
        ride the batcher as independent items, then reassembled in order;
        the result gains a "num_chunks" key."""
        wav = np.asarray(wav, np.float32)
        src_win = int(self.n_samples * sample_rate / 16000)
        if len(wav) <= src_win:
            return self._submit_window(wav, sample_rate)
        from .evaluation.longform import chunk_waveform

        t_submit = time.perf_counter()
        futs = [self._submit_window(c, sample_rate, internal=True)
                for c in chunk_waveform(wav, src_win)]
        agg: Future = Future()
        remaining = [len(futs)]
        lock = threading.Lock()

        def _one_done(_f):
            with lock:
                remaining[0] -= 1
                if remaining[0]:
                    return
            try:
                parts = [f.result() for f in futs]  # all done; no blocking
                latency = time.perf_counter() - t_submit
                if not agg.done():
                    agg.set_result({
                        "text": " ".join(p["text"] for p in parts
                                         if p["text"]),
                        "tokens": [t for p in parts for t in p["tokens"]],
                        "audio_seconds": sum(p["audio_seconds"]
                                             for p in parts),
                        "latency_s": latency,
                        "num_chunks": len(parts),
                    })
                # the user-facing request latency (per-window latencies are
                # internal and excluded from stats for chunked requests)
                with self.stats._lock:
                    self.stats.user_requests += 1
                    if len(self.stats.latencies) < ServiceStats.MAX_LATENCIES:
                        self.stats.latencies.append(latency)
            except Exception as e:
                if not agg.done():
                    agg.set_exception(e)

        for f in futs:
            f.add_done_callback(_one_done)
        return agg

    def submit_flac(self, data: bytes) -> Future:
        """Enqueue one FLAC-encoded utterance.

        Short requests (at most one 30 s window) carry the compressed bytes
        to the native BatchLoader, which decodes, downmixes and resamples
        in its worker pool. Longer audio decodes up front and rides the
        chunked `submit` path. Raises ValueError at once on malformed or
        truncated metadata; frame-level corruption surfaces later as the
        request future's exception, never as a batch-wide failure."""
        from .audio.flac import parse_stream_info

        try:
            info, _ = parse_stream_info(data)
        except EOFError as e:  # truncated metadata
            raise ValueError(f"malformed FLAC stream: {e}") from e
        src_win = int(self.n_samples * info.sample_rate / 16000)
        if 0 < info.total_samples <= src_win:
            return self._submit_window(
                _FlacRequest(data, info.total_samples), info.sample_rate)
        from .runtime_native import flac_decode

        samples, sr, bits = flac_decode(data)
        wav = samples.astype(np.float32) / float(1 << (bits - 1))
        wav = wav.mean(axis=1) if wav.shape[1] > 1 else wav[:, 0]
        return self.submit(wav, sr)

    def _submit_window(self, wav, sample_rate: int,
                       internal: bool = False) -> Future:
        if self._stop.is_set():
            raise RuntimeError("service is shut down")
        fut: Future = Future()
        if not isinstance(wav, _FlacRequest):
            wav = np.asarray(wav, np.float32)
        self._queue.put((wav, sample_rate, fut,
                         time.perf_counter(), internal))
        with self.stats._lock:
            self.stats.queue_peak = max(self.stats.queue_peak,
                                        self._queue.qsize())
        return fut

    def transcribe(self, wav: np.ndarray, sample_rate: int = 16000,
                   timeout: float | None = None) -> dict:
        """Blocking submit+result. timeout=None scales with the audio:
        max(120 s, 4x its duration)."""
        if timeout is None:
            timeout = max(120.0, 4.0 * len(wav) / float(sample_rate))
        return self.submit(wav, sample_rate).result(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue and stop the worker."""
        self._stop.set()
        self._worker.join(timeout=timeout)

    # ---------------------------------------------------------------- worker
    def _take_batch(self) -> list:
        """Block for the first request, then gather co-riders until the
        batch fills or max_wait elapses."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(items) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self) -> None:
        """Worker loop: assemble -> dispatch -> retire, keeping up to
        `pipeline` batches in flight; under low load (nothing queued)
        everything in flight retires at once, so idle-queue latency is
        never inflated by pipeline residency."""
        inflight: deque = deque()  # (items, failed, tokens, lengths, t0)
        while True:
            stopping = self._stop.is_set() and self._queue.empty()
            if stopping and not inflight:
                break
            items = [] if stopping else self._take_batch()
            if items:
                failed: dict[int, Exception] = {}
                try:
                    for slot in range(self.batch_size):
                        self._loader.clear(slot)
                    for slot, (wav, sr, _, _, _) in enumerate(items):
                        try:
                            if isinstance(wav, _FlacRequest):
                                self._loader.submit_flac(slot, wav.data)
                            else:
                                self._loader.submit(slot, wav,
                                                    sample_rate=sr)
                        except Exception as e:  # the pure-Python FLAC
                            # decoder raises at submit: fail THIS request
                            failed[slot] = e
                            self._loader.clear(slot)
                    # native decode failures surface per slot after flush:
                    # one corrupt frame must not fail its co-riding batch
                    buf = self._loader.flush(raise_on_error=False)
                    for slot in self._loader.take_error_slots():
                        failed.setdefault(slot, ValueError(
                            "FLAC decode failed (corrupt frame data)"))
                    if self.transfer == "int16":
                        buf = _pcm16(buf)
                    elif self.transfer == "mulaw":
                        buf = mulaw_encode(buf)

                    bucket = next(b for b in self.buckets
                                  if b >= len(items))
                    t0 = time.perf_counter()
                    tokens, lengths = self._fn(self.params, buf[:bucket])[:2]
                    inflight.append((items, failed, tokens, lengths, t0))
                except Exception as e:  # fail the batch, keep serving
                    for _, _, fut, _, _ in items:
                        if not fut.done():
                            fut.set_exception(e)
                # pipeline full: retire the oldest
                while len(inflight) >= self.pipeline:
                    self._finalize(inflight.popleft())
                # trickle load: nothing waits to pipeline with, finalize now
                if self._queue.empty():
                    while inflight:
                        self._finalize(inflight.popleft())
            else:
                while inflight:  # low load / draining: retire everything
                    self._finalize(inflight.popleft())

    def _finalize(self, entry) -> None:
        """Read one in-flight batch's results back and resolve its futures.
        Busy accounting merges overlapping dispatch windows: each
        wall-clock second counts at most once."""
        items, failed, tokens, lengths, t0 = entry
        try:
            tokens = tokens.cpu().numpy()   # readback = completion fence
            lengths = lengths.cpu().numpy()
        except Exception as e:  # an asynchronous device failure
            for _, _, fut, _, _ in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        now = time.perf_counter()
        busy = max(0.0, now - max(t0, self._busy_mark))
        self._busy_mark = max(self._busy_mark, now)

        audio_s = 0.0
        for slot, (wav, sr, fut, t_submit, _) in enumerate(items):
            if slot in failed:
                if not fut.done():
                    fut.set_exception(failed[slot])
                continue
            ids = tokens[slot, self._first_gen: lengths[slot]]
            ids = ids[ids != self.arch.eos_token_id]
            dur = len(wav) / float(sr)
            audio_s += dur
            if not fut.done():   # the user may have cancelled while queued
                fut.set_result({
                    "text": self.tokenizer.decode(ids.tolist()),
                    "tokens": ids.tolist(),
                    "audio_seconds": dur,
                    "latency_s": now - t_submit,
                })
        with self.stats._lock:
            self.stats.requests += len(items)
            self.stats.batches += 1
            self.stats.occupancy_sum += len(items) / self.batch_size
            self.stats.audio_seconds += audio_s
            self.stats.busy_seconds += busy
            # latency percentiles are USER-facing: direct (non-chunk)
            # windows only; chunked requests report their aggregate
            self.stats.user_requests += sum(
                1 for it in items if not it[4])
            if len(self.stats.latencies) < ServiceStats.MAX_LATENCIES:
                self.stats.latencies.extend(
                    now - t for (_, _, _, t, internal) in items
                    if not internal)
