"""Streaming (incremental) transcription with stable-prefix commitment.

The JAX package's `streaming.py`. Policy: **LocalAgreement-n** (the
whisper-streaming recipe): after each re-decode of the live window, the
stable prefix is the longest common prefix of the last n hypotheses; only
that prefix is surfaced as committed text, and commitment never retracts.
When the live window fills 30 s, the transcriber finalizes every complete
segment inside the committed prefix, slides the window to that boundary
(timestamp seek, the rules of `evaluation.longform.transcribe_seek`) and
carries the committed tokens as `<|startofprev|>` prompt conditioning.

Every decode goes through one step function (mel → `encode` →
`verified_greedy_decode` with the previous decode as its self-draft, or
`beam_decode` for beam configurations) over a padded 30 s window and a
right-aligned fixed-width prompt, returning one packed tensor, so a tick
costs one host readback.

`StreamingPool` multiplexes many sessions through that step at a fixed
batch: a `(max_streams, n_samples)` f32 mirror on the device holds each
session's live window (its row pinned for the session's lifetime), and each
batched call first shifts the mirror and appends only the audio the host
received since, so only new audio crosses to the device. Everything runs
on `device` (the card unless the caller names another; `params` must live
there).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .config import SAMPLE_RATE, DecodeConfig, WhisperArch
from .evaluation.harness import samples_for_arch
from .evaluation.longform import _encode_wav, _seed_prompt, segments_from_tokens
from .models.params import DEFAULT_DEVICE, resolve_device


def _build_step(arch: WhisperArch, cfg: DecodeConfig, n_samples: int,
                use_prompt: bool, device: str | torch.device = DEFAULT_DEVICE):
    """One preprocess → encode → decode step (any batch size), shared by
    StreamingTranscriber (B = 1) and StreamingPool (B = streams).

    step(params, wav, prompt, plen, draft, draft_len, active) -> packed
    (B, L + 2) int64 on `device`: [tokens | lengths | n_accepted]. Inputs
    may be numpy arrays or tensors anywhere. `active` (B,) bool marks real
    rows: padding lanes of a partial pool batch must not hold back the
    verified decode's batch-min continuation. Greedy configurations run
    `verified_greedy_decode` over the caller's draft (the previous tick's
    hypothesis: any draft gives greedy's tokens; it moves work from the
    sequential steps into one verify pass); beam configurations ignore the
    draft and run `beam_decode`. The mel is the f32 DFT log-mel in the
    tree's dtype (`longform._encode_wav`)."""
    from .models.decode import beam_decode
    from .models.speculative import verified_greedy_decode

    device = resolve_device(device)

    def dev(x, dtype=None):
        x = torch.as_tensor(x)
        return x.to(device=device, dtype=dtype or x.dtype)

    @torch.inference_mode()
    def step(params, wav, prompt, plen, draft, draft_len, active):
        enc = _encode_wav(params, arch, dev(wav, torch.float32))
        kw = (dict(prompt_tokens=dev(prompt, torch.long), prompt_lens=dev(plen))
              if use_prompt else {})
        if cfg.beam_size > 1:
            tokens, lengths = beam_decode(params, arch, enc, cfg, **kw)
            acc = torch.zeros_like(lengths)
        else:
            tokens, lengths, acc = verified_greedy_decode(
                params, arch, enc, cfg, dev(draft, torch.long), dev(draft_len),
                active=dev(active, torch.bool), **kw)
        return torch.cat([tokens.long(), lengths[:, None].long(), acc[:, None].long()],
                         dim=1)

    return step


def _lcp(seqs: list[tuple]) -> int:
    """Length of the longest common prefix across token sequences."""
    if not seqs:
        return 0
    n = min(len(s) for s in seqs)
    for i in range(n):
        t = seqs[0][i]
        if any(s[i] != t for s in seqs[1:]):
            return i
    return n


def _prompt_width(arch: WhisperArch, cfg: DecodeConfig, prompt_window: int) -> int:
    """The prompt window clamped so the forced prefix and the generated
    tokens keep their room in the position budget (0 when under 2: no room
    for <|startofprev|> and a token)."""
    from .models.decode import forced_prefix

    p_len = len(forced_prefix(arch, cfg))
    max_pw = arch.max_target_positions - p_len - cfg.max_new_tokens - 1
    pw = max(min(int(prompt_window), max_pw), 0)
    return 0 if pw < 2 else pw


class StreamingTranscriber:
    """Incremental transcriber: `feed(samples)` audio as it arrives, read
    back `{"committed", "pending"}`; `flush()` finalizes the tail.

    agreement: LocalAgreement window (n successive hypotheses must agree
    before text is committed; 1 = commit every decode immediately).
    min_step_s: don't re-decode until at least this much new audio arrived.
    vad_threshold: windows whose RMS is below it skip decoding (None:
    always decode). step_fn: a StreamingPool's step for one row.
    """

    def __init__(self, params, arch: WhisperArch, tokenizer,
                 cfg: DecodeConfig | None = None, agreement: int = 2,
                 min_step_s: float = 1.0, prompt_window: int = 32,
                 condition_on_previous_text: bool = True,
                 vad_threshold: float | None = None,
                 step_fn=None, device: str | torch.device = DEFAULT_DEVICE):
        from .models.decode import _timestamps_enabled, forced_prefix

        cfg = cfg or DecodeConfig(notimestamps=False)
        if not _timestamps_enabled(arch, cfg):
            raise ValueError("streaming needs timestamp decoding "
                             "(notimestamps=False and a vocab with "
                             "timestamp tokens) to slide the window")
        if agreement < 1:
            raise ValueError("agreement must be >= 1")
        self.device = resolve_device(device)
        self.arch, self.tokenizer, self.cfg = arch, tokenizer, cfg
        self.params = params
        self.agreement = int(agreement)
        # >= 1 sample: a zero step would re-decode one window forever
        self.min_step = max(int(min_step_s * SAMPLE_RATE), 1)
        self.vad = vad_threshold
        self.pw = _prompt_width(arch, cfg, prompt_window)
        self.condition = condition_on_previous_text and self.pw > 0
        self.n_samples = samples_for_arch(arch)
        self._first_gen = self.pw + len(forced_prefix(arch, cfg))
        self._step = (step_fn if step_fn is not None
                      else _build_step(arch, cfg, self.n_samples, self.pw > 0,
                                       self.device))
        # the buffer holds only un-consumed audio: `_base` is the absolute
        # sample index of _buf[0]; slides drop everything before the window
        self._buf = np.zeros((0,), np.float32)
        self._base = 0
        self._total = 0                   # samples received all-time
        self._window_start = 0            # absolute sample of live window
        self._decoded_until = 0           # absolute sample of last decode
        # self-draft for the verified decode: the previous decode's raw
        # generated tokens; slides re-anchor its timestamps, resets clear it
        self._draft: np.ndarray | None = None
        self._hyps: deque = deque(maxlen=self.agreement)
        self._win_segments: list[dict] = []   # last decode, absolute times
        # committed-but-not-finalized token ids (tokens, not an index into
        # the live hypothesis: a disagreeing re-decode cannot rewrite them)
        self._exposed_ids: list[int] = []
        self._final_ids: list[int] = []   # finalized (slid-past) tokens
        self._final_segments: list[dict] = []
        self._prompt_ids: list[int] = []

    # -- internals ----------------------------------------------------------

    def _window(self) -> np.ndarray:
        lo = self._window_start - self._base
        return self._buf[lo: lo + self.n_samples]

    def _silent(self, x: np.ndarray) -> bool:
        return (self.vad is not None
                and (len(x) == 0
                     or float(np.sqrt(np.mean(x * x))) < self.vad))

    def _flat(self) -> tuple:
        return tuple(t for s in self._win_segments for t in s["tokens"])

    def _common(self, flat: tuple | None = None) -> int:
        """How far the live hypothesis agrees with the committed tokens."""
        flat = self._flat() if flat is None else flat
        return _lcp([tuple(self._exposed_ids), flat])

    def _prompt_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """(prompt (1, pw), plen (1,)) rows for the step (a pool batches
        them without host window copies)."""
        ids = self._prompt_ids if self.condition else []
        if ids:
            return _seed_prompt(ids, self.pw, self.arch.eos_token_id,
                                self.arch.vocab_size)
        # no context: plen=0, no dangling <|startofprev|>
        return (np.full((1, self.pw), self.arch.eos_token_id, np.int32),
                np.zeros((1,), np.int32))

    def _decode_inputs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(window, prompt, plen) rows for the step."""
        piece = self._window()
        buf = np.zeros((1, self.n_samples), np.float32)
        buf[0, : len(piece)] = piece
        prompt, plen = self._prompt_inputs()
        return buf, prompt, plen

    def _draft_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """(draft (1, G), draft_len (1,)): the previous decode of (nearly)
        this window, EOT-padded."""
        g = self.cfg.max_new_tokens
        d = np.full((1, g), self.arch.eos_token_id, np.int32)
        n = 0
        if self._draft is not None:
            n = min(len(self._draft), g)
            d[0, :n] = self._draft[:n]
        return d, np.asarray([n], np.int32)

    def _absorb(self, tokens: np.ndarray, length: int) -> None:
        """Ingest one decoded row (counterpart of _decode_inputs)."""
        gen = np.asarray(tokens)[self._first_gen: int(length)]
        self._draft = gen.astype(np.int32)   # next tick's self-draft
        segments, _ = segments_from_tokens(self.arch, gen)
        t0 = self._window_start / SAMPLE_RATE
        self._win_segments = [{
            "start": t0 + s["start"],
            "end": None if s["end"] is None else t0 + s["end"],
            "tokens": [int(t) for t in s["tokens"]],
        } for s in segments]
        flat = self._flat()
        self._hyps.append(flat)
        stable = (_lcp(list(self._hyps))
                  if len(self._hyps) == self.agreement else 0)
        # extend committed tokens only when the live hypothesis still starts
        # with them (divergence never rewrites committed text)
        common = self._common(flat)
        if common == len(self._exposed_ids) and stable > common:
            self._exposed_ids = list(flat[:stable])
        self._decoded_until = self._total

    def _decode_window(self) -> None:
        buf, prompt, plen = self._decode_inputs()
        draft, dlen = self._draft_inputs()
        packed = self._step(self.params, buf, prompt, plen, draft, dlen,
                            np.ones((1,), bool)).cpu().numpy()
        self._absorb(packed[0, :-2], int(packed[0, -2]))

    def _complete_within(self, n_tokens: int) -> int:
        """Index AFTER the last window segment that is fully inside the
        first n_tokens AND has a closing timestamp; 0 if none."""
        count = k = 0
        for i, s in enumerate(self._win_segments):
            count += len(s["tokens"])
            if count <= n_tokens and s["end"] is not None:
                k = i + 1
        return k

    def _slide(self) -> None:
        """Finalize committed complete segments and advance the window."""
        flat = self._flat()
        common = self._common(flat)
        k = self._complete_within(common)
        if k == 0:
            # nothing committed+complete: finalize the committed tokens plus
            # the hypothesis tail and advance a full window; a hypothesis
            # diverging inside the committed prefix is discarded (appending
            # both would transcribe the overlapping audio twice)
            extends = common == len(self._exposed_ids)
            self._final_ids += self._exposed_ids + (
                list(flat[common:]) if extends else [])
            if extends:
                self._final_segments.extend(self._win_segments)
            self._exposed_ids = []
            advance = self.n_samples
        else:
            m = sum(len(s["tokens"]) for s in self._win_segments[:k])
            self._final_ids += list(flat[:m])       # == exposed_ids[:m]
            self._exposed_ids = self._exposed_ids[m:]
            self._final_segments.extend(self._win_segments[:k])
            end_s = self._win_segments[k - 1]["end"]
            advance = max(int(end_s * SAMPLE_RATE) - self._window_start, 1)
        carry = self._win_segments[k:] if k > 0 else []
        self._prompt_ids = (self._final_ids + self._exposed_ids
                            )[-(self.pw - 1):]
        self._window_start += min(advance, self.n_samples)
        self._trim_buffer()
        self._reset_window()
        # re-anchor the surviving hypothesis tail as the new window's
        # self-draft: its timestamps shifted to the new window origin
        if carry:
            ts_begin = self.arch.no_timestamps_token_id + 1
            hi = self.arch.vocab_size - 1
            t0 = self._window_start / SAMPLE_RATE
            draft: list[int] = []

            def ts_tok(sec: float) -> int:
                return min(max(ts_begin + round((sec - t0) / 0.02),
                               ts_begin), hi)

            for s in carry:
                draft.append(ts_tok(s["start"]))
                draft.extend(s["tokens"])
                if s["end"] is not None:
                    draft.append(ts_tok(s["end"]))
            self._draft = np.asarray(draft, np.int32)

    def _trim_buffer(self) -> None:
        drop = min(self._window_start, self._total) - self._base
        if drop > 0:
            self._buf = self._buf[drop:]
            self._base += drop

    def _reset_window(self) -> None:
        self._hyps.clear()
        self._win_segments = []
        self._draft = None      # _slide re-anchors its own carry after this

    def _texts(self) -> dict:
        flat = self._flat()
        common = self._common(flat)
        return {
            "committed": self.tokenizer.decode(self._final_ids
                                               + self._exposed_ids),
            "pending": self.tokenizer.decode(list(flat[common:])),
            "segments": list(self._final_segments),
            "buffered_s": (self._total - self._window_start) / SAMPLE_RATE,
        }

    def _pump(self) -> None:
        """Decode-free progress: fast-forward silent full windows, slide
        once a full window has a decoded hypothesis, retire silent
        min-steps. Leaves the state caught up or wanting a decode."""
        while True:
            if self._total - self._window_start > self.n_samples:
                # decoded hypotheses finalize via slide BEFORE any VAD
                # fast-forward: trailing silence diluting a full window's
                # RMS must not discard already-decoded speech
                if self._hyps:
                    self._slide()
                    continue
                if self._silent(self._window()):
                    self._window_start += self.n_samples
                    self._trim_buffer()
                    self._reset_window()
                    continue
            elif (self._total - self._decoded_until >= self.min_step
                    and self._silent(self._window())):
                self._decoded_until = self._total   # nothing to transcribe
            return

    def wants_decode(self) -> bool:
        """True when progress needs a model call: a full (non-silent)
        window awaiting its hypothesis, or >= min_step_s of new audio."""
        if self._silent(self._window()):
            return False
        if self._total - self._window_start > self.n_samples:
            return not self._hyps
        return self._total - self._decoded_until >= self.min_step

    # -- public API ---------------------------------------------------------

    def _ingest(self, samples: np.ndarray) -> int:
        """Append raw audio to the stream buffer; returns samples added."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if len(samples):
            self._buf = np.concatenate([self._buf, samples])
            self._total += len(samples)
        return len(samples)

    def feed(self, samples: np.ndarray) -> dict:
        """Append audio; re-decode when >= min_step_s new audio accumulated
        (sliding first whenever the live window is full). Returns the
        current {"committed", "pending", "segments", "buffered_s"}."""
        self._ingest(samples)
        self._pump()
        while self.wants_decode():
            self._decode_window()
            self._pump()
        return self._texts()

    def flush(self) -> dict:
        """Finalize: decode any undecoded tail and commit everything."""
        self._pump()
        while self.wants_decode():
            self._decode_window()
            self._pump()
        if (self._total > self._window_start
                and not self._silent(self._window())
                and (not self._hyps or self._total > self._decoded_until)):
            self._decode_window()   # sub-min_step tail still transcribed
        flat = self._flat()
        common = self._common(flat)
        extends = common == len(self._exposed_ids)
        self._final_ids += self._exposed_ids + (
            list(flat[common:]) if extends else [])   # no divergence dup
        if extends:
            self._final_segments.extend(self._win_segments)
        self._exposed_ids = []
        self._reset_window()
        self._window_start = self._total
        self._trim_buffer()
        out = self._texts()
        out["pending"] = ""
        return out


def _advance(buf: torch.Tensor, shifts: np.ndarray, chunk: np.ndarray,
             offs: np.ndarray, nvalid: np.ndarray) -> None:
    """In place, per row r of the (B, n) mirror: drop `shifts[r]` samples
    from the front (zero-filling the tail), then write chunk[r, :nvalid[r]]
    at offset offs[r]. The new pieces cross to the device in one copy."""
    n = buf.shape[1]
    for r in np.nonzero(shifts)[0]:
        sh = min(int(shifts[r]), n)
        if sh < n:
            buf[r, : n - sh] = buf[r, sh:].clone()
        buf[r, n - sh:] = 0
    rows = np.nonzero(nvalid)[0]
    if not len(rows):
        return
    flat = torch.from_numpy(np.concatenate([chunk[r, : nvalid[r]] for r in rows]))
    flat = flat.to(buf.device)
    at = 0
    for r in rows:
        lo, nv = int(offs[r]), int(nvalid[r])
        buf[r, lo: lo + nv] = flat[at: at + nv]
        at += nv


class StreamingPool:
    """Multiplex many live streams through ONE batched decode step.

    N concurrent sessions re-decode their live windows in a single
    (max_streams, 30 s) batch per tick instead of N batch-1 calls.
    Sessions are ordinary StreamingTranscribers sharing the pool's step, so
    `feed`/`flush` also work directly on a session (one row rides the same
    batched step, padded).

    Usage::

        pool = StreamingPool(params, arch, tok, cfg, max_streams=8)
        pool.open("a"); pool.open("b")
        pool.feed("a", chunk_a); pool.feed("b", chunk_b)
        partials = pool.tick()          # one batched decode round
        final_a = pool.close("a")
    """

    def __init__(self, params, arch: WhisperArch, tokenizer,
                 cfg: DecodeConfig | None = None, max_streams: int = 8,
                 device: str | torch.device = DEFAULT_DEVICE, **session_kw):
        cfg = cfg or DecodeConfig(notimestamps=False)
        if max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        self.device = resolve_device(device)
        self.params, self.arch, self.tokenizer, self.cfg = (params, arch,
                                                            tokenizer, cfg)
        self.B = int(max_streams)
        self.session_kw = dict(session_kw)
        # the sessions' prompt-budget clamp, so the batched step and every
        # session agree on shapes
        pw = _prompt_width(arch, cfg, self.session_kw.get("prompt_window", 32))
        self._pw = pw
        n_samples = samples_for_arch(arch)
        self._n_samples = n_samples
        B = self.B
        batched_step = _build_step(arch, cfg, n_samples, pw > 0, self.device)
        self._batched_step = batched_step
        g_w = cfg.max_new_tokens
        self._g = g_w

        def single_step(params_, wav, prompt, plen, draft, dlen, _active):
            # pad one session's row into the shared batched step
            wavB = np.zeros((B, n_samples), np.float32)
            wavB[0] = np.asarray(wav)[0]
            pB = np.full((B, pw), arch.eos_token_id, np.int32)
            lB = np.zeros((B,), np.int32)
            if pw:
                pB[0] = np.asarray(prompt)[0]
                lB[0] = np.asarray(plen)[0]
            dB = np.full((B, g_w), arch.eos_token_id, np.int32)
            dB[0] = np.asarray(draft)[0]
            dlB = np.zeros((B,), np.int32)
            dlB[0] = np.asarray(dlen)[0]
            actB = np.zeros((B,), bool)
            actB[0] = True
            return batched_step(params_, wavB, pB, lB, dB, dlB, actB)[:1]

        self._single_step = single_step
        self.sessions: dict = {}
        # the device window mirror: one row per session holding EXACTLY its
        # live window, zero past the valid length; sessions are PINNED to
        # rows for their lifetime (open/close allocate)
        self._mirror = torch.zeros((B, n_samples), dtype=torch.float32,
                                   device=self.device)
        self._mstart = [0] * B        # abs sample index of row[0]
        self._mlen = [0] * B          # valid samples in the row
        self._row_of: dict = {}       # sid -> pinned row
        self._free_rows = list(range(B - 1, -1, -1))
        self._mzero: set = set()      # rows needing a zero-flush on reuse
        self._append_w = min(max(2 * SAMPLE_RATE, 1), n_samples)
        # serving-style counters; draft_proposed/accepted: the self-draft's
        # hit rate (the verified decode's sequential steps scale with what
        # it rejects)
        self._stats = {"ticks": 0, "batched_calls": 0, "decodes": 0,
                       "occupancy_sum": 0.0, "busy_seconds": 0.0,
                       "audio_seconds": 0.0,
                       "draft_proposed": 0, "draft_accepted": 0}

    def reset_stats(self) -> None:
        """Zero the counters (e.g. to exclude a warmup tick)."""
        self._stats = {k: (0 if isinstance(v, int) else 0.0)
                       for k, v in self._stats.items()}

    def stats(self) -> dict:
        """Occupancy/throughput snapshot: mean decode-batch occupancy,
        decodes per tick, busy seconds (batched calls through their
        readback), stream-audio RTFx over them."""
        s = dict(self._stats)
        s["open_streams"] = len(self.sessions)
        s["mean_batch_occupancy"] = (s.pop("occupancy_sum") /
                                     s["batched_calls"]
                                     if s["batched_calls"] else 0.0)
        s["rtfx"] = (s["audio_seconds"] / s["busy_seconds"]
                     if s["busy_seconds"] else 0.0)
        return s

    def open(self, sid) -> None:
        if sid in self.sessions:
            raise KeyError(f"session {sid!r} already open")
        if not self._free_rows:
            raise RuntimeError(f"pool full ({self.B} streams)")
        row = self._free_rows.pop()
        self._row_of[sid] = row
        self._mstart[row] = 0
        self._mlen[row] = 0
        self._mzero.add(row)    # reused rows carry stale audio: zero first
        self.sessions[sid] = StreamingTranscriber(
            self.params, self.arch, self.tokenizer, self.cfg,
            step_fn=self._single_step, device=self.device, **self.session_kw)

    def _sync_mirrors(self, rows_needed) -> None:
        """Bring each (sid, row)'s mirror current: shift out the samples the
        session's window slid past, then append only the audio the host
        buffer holds beyond the mirror, in rounds of at most 2 s a row."""
        n, A = self._n_samples, self._append_w
        round0 = True
        while True:
            shifts = np.zeros((self.B,), np.int64)
            offs = np.zeros((self.B,), np.int64)
            nvalid = np.zeros((self.B,), np.int64)
            chunk = np.zeros((self.B, A), np.float32)
            work = False
            for sid, r in rows_needed:
                s = self.sessions[sid]
                ws = s._window_start
                if round0:
                    if r in self._mzero:
                        sh = n          # flush stale reused-row audio
                        self._mzero.discard(r)
                        self._mlen[r] = 0
                    else:
                        sh = ws - self._mstart[r]
                        if sh < 0 or sh > self._mlen[r]:
                            sh = self._mlen[r]   # rewound/overrun: rebuild
                        self._mlen[r] = max(self._mlen[r] - sh, 0)
                    shifts[r] = sh
                    self._mstart[r] = ws
                    if sh:
                        work = True
                want = min(s._total - ws, n)
                missing = want - self._mlen[r]
                if missing > 0:
                    take = min(missing, A)
                    lo = ws - s._base + self._mlen[r]
                    chunk[r, :take] = s._buf[lo: lo + take]
                    offs[r] = self._mlen[r]
                    nvalid[r] = take
                    self._mlen[r] += take
                    work = True
            if not work:
                return
            _advance(self._mirror, shifts, chunk, offs, nvalid)
            round0 = False

    def feed(self, sid, samples: np.ndarray) -> dict:
        """Buffer audio for one session WITHOUT decoding (decode-free
        catch-up only); call tick() to run the batched decodes."""
        s = self.sessions[sid]
        self._stats["audio_seconds"] += s._ingest(samples) / SAMPLE_RATE
        s._pump()
        return s._texts()

    def tick(self) -> dict:
        """Run batched decode rounds until no session wants one; returns
        {sid: partials} for every open session."""
        self._stats["ticks"] += 1
        while True:
            # open() caps sessions at B, so one batch always covers `group`
            group = [(sid, s) for sid, s in self.sessions.items()
                     if s.wants_decode()]
            if not group:
                break
            # audio rides the device mirror (rows pinned per session); the
            # host sends prompts, drafts and the new-audio appends
            self._sync_mirrors([(sid, self._row_of[sid]) for sid, _ in group])
            prompt = np.full((self.B, self._pw),
                             self.arch.eos_token_id, np.int32)
            plen = np.zeros((self.B,), np.int32)
            draft = np.full((self.B, self._g),
                            self.arch.eos_token_id, np.int32)
            dlen = np.zeros((self.B,), np.int32)
            active = np.zeros((self.B,), bool)
            for sid, s in group:
                r = self._row_of[sid]
                active[r] = True
                if self._pw:
                    p, ln = s._prompt_inputs()
                    prompt[r] = p[0]
                    plen[r] = ln[0]
                d, dl = s._draft_inputs()
                draft[r] = d[0]
                dlen[r] = dl[0]
            t0 = time.perf_counter()
            packed = self._batched_step(   # ONE readback fence
                self.params, self._mirror, prompt, plen, draft, dlen,
                active).cpu().numpy()
            toks, lens, acc = packed[:, :-2], packed[:, -2], packed[:, -1]
            self._stats["busy_seconds"] += time.perf_counter() - t0
            self._stats["batched_calls"] += 1
            self._stats["decodes"] += len(group)
            self._stats["occupancy_sum"] += len(group) / self.B
            self._stats["draft_proposed"] += int(dlen[active].sum())
            self._stats["draft_accepted"] += int(
                np.minimum(acc[active], dlen[active]).sum())
            for sid, s in group:
                r = self._row_of[sid]
                s._absorb(toks[r], int(lens[r]))
                s._pump()
        return {sid: s._texts() for sid, s in self.sessions.items()}

    def close(self, sid) -> dict:
        """Flush and remove a session; returns its final transcript."""
        s = self.sessions.pop(sid)
        row = self._row_of.pop(sid)
        self._free_rows.append(row)
        self._mlen[row] = 0
        return s.flush()
