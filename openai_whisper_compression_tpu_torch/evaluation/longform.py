"""Long-form transcription: fixed 30 s chunking and timestamp seeking.

The JAX package's `evaluation/longform.py`. `transcribe_long` splits
arbitrary-length audio into 30 s windows, batches them through the
transcription function and joins the texts (optionally conditioned on the
previous chunk, with a temperature-fallback ladder, or seeded by an initial
prompt). `transcribe_seek` is OpenAI transcribe()'s seek loop: decode a
window with the timestamp rules, advance to the end of its last complete
segment, repeat; with word timestamps (cross-attention DTW,
`models.alignment`), clip ranges, the hallucination-silence rules, the
fallback ladder and prompt conditioning. `transcribe_seek_batch`
multiplexes the windows of many streams into one fixed-batch decode.

The JAX module's jit caches (`_cut_windows_fn`, `_enc_fn`, `_cond_fn`,
`_nsp_fn`) are plain functions here: eager PyTorch has nothing to compile.
Every entry point runs on `device` (the card unless the caller names
another); `params` must live there.

Not carried over: the JAX `transcribe_seek_batch` gives the idle rows of
its last iterations stream 0's window (index and offset 0) where its
docstring promises zero padding; here they are zeros (silence).
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio import features
from ..config import DecodeConfig, WhisperArch
from ..models.params import DEFAULT_DEVICE, resolve_device
from .harness import make_transcribe_fn, samples_for_arch

PCM16_SCALE = 1.0 / 32767.0   # int16 pool -> f32 samples, as the JAX cut


def _cut_windows(pool: torch.Tensor, starts: list[tuple[int, int]],
                 batch_size: int, n_samples: int) -> torch.Tensor:
    """The (batch_size, n_samples) f32 window batch, cut on the pool's
    device: row r is stream s from sample o for (s, o) = starts[r], the rows
    past len(starts) are zeros. An int16 pool is dequantized by
    * f32(1 / 32767) (lossless for PCM16-sourced audio)."""
    out = torch.zeros((batch_size, n_samples), dtype=torch.float32,
                      device=pool.device)
    for r, (s, o) in enumerate(starts):
        out[r] = pool[s, o: o + n_samples]
    if pool.dtype == torch.int16:
        out *= PCM16_SCALE
    return out


def chunk_waveform(wav: np.ndarray, n_samples: int,
                   overlap: float = 0.0) -> list[np.ndarray]:
    """Split into fixed windows (optional fractional overlap); the final
    window is zero-padded by the frontend."""
    hop = int(n_samples * (1.0 - overlap)) or n_samples
    chunks = []
    for start in range(0, max(len(wav), 1), hop):
        piece = wav[start: start + n_samples]
        if len(piece) == 0:
            break
        chunks.append(piece)
        if start + n_samples >= len(wav):
            break
    return chunks


SOT_PREV = 50361  # <|startofprev|>


def _encode_wav(params, arch: WhisperArch, wav: torch.Tensor,
                mel_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Encoder states of a (B, n_samples) batch on the params' device: the
    f32 DFT log-mel in `mel_dtype` (the tree's by default), then `encode`."""
    from ..models.whisper import encode

    dev = params["encoder"]["ln"]["g"].device
    mel = features.preprocess(wav.to(dev), n_mels=arch.num_mel_bins,
                              length=samples_for_arch(arch))
    return encode(params, arch, mel.to(mel_dtype or params["encoder"]["ln"]["g"].dtype))


def transcribe_long(params, arch: WhisperArch, wav: np.ndarray, tokenizer,
                    cfg: DecodeConfig | None = None, batch_size: int = 8,
                    transcribe_fn=None, condition_on_previous: bool = False,
                    prompt_window: int = 64,
                    temperatures: tuple[float, ...] | None = None,
                    fallback_kw: dict | None = None,
                    initial_prompt: str | None = None,
                    device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Arbitrary-length waveform -> {"text", "chunks", "audio_seconds",
    "num_chunks"}.

    condition_on_previous=True feeds each chunk the previous chunk's tokens
    as a decoder prompt (OpenAI `condition_on_previous_text`); the chunks
    then decode one by one instead of batched.

    temperatures: OpenAI's temperature-fallback ladder per chunk batch
    (`models.fallback`); fallback_kw forwards threshold overrides to
    `decode_with_fallback`.

    initial_prompt: text fed as the first window's decoder prompt (needs
    tokenizer.encode). With condition_on_previous it seeds the rolling
    prompt; otherwise only the first chunk decodes prompted (OpenAI's
    prompt reset when conditioning is off)."""
    cfg = cfg or DecodeConfig()
    if condition_on_previous and temperatures is not None:
        raise ValueError("condition_on_previous + temperatures is not "
                         "supported (the prompt-conditioned path has no "
                         "fallback ladder); pick one")
    device = resolve_device(device)
    n_samples = samples_for_arch(arch)
    chunks = chunk_waveform(np.asarray(wav, np.float32), n_samples)

    seed_ids = (list(tokenizer.encode(initial_prompt)) if initial_prompt else None)
    if condition_on_previous:
        texts = _transcribe_conditioned(params, arch, chunks, tokenizer, cfg,
                                        n_samples, prompt_window, seed_ids=seed_ids)
    elif seed_ids:
        # the first window prompted; the rest ride the batched path unprompted
        texts = _transcribe_conditioned(params, arch, chunks[:1], tokenizer, cfg,
                                        n_samples, prompt_window, seed_ids=seed_ids)
        if len(chunks) > 1:
            rest = transcribe_long(
                params, arch,
                np.concatenate([np.asarray(c, np.float32) for c in chunks[1:]]),
                tokenizer, cfg=cfg, batch_size=batch_size,
                transcribe_fn=transcribe_fn, temperatures=temperatures,
                fallback_kw=fallback_kw, device=device)
            texts = texts + rest["chunks"]
    elif temperatures is not None:
        from ..models.fallback import decode_with_fallback

        texts = []
        for i in range(0, len(chunks), batch_size):
            batch = chunks[i: i + batch_size]
            buf = np.zeros((batch_size, n_samples), np.float32)
            for j, c in enumerate(batch):
                buf[j, : len(c)] = c
            with torch.inference_mode():
                enc = _encode_wav(params, arch, torch.from_numpy(buf))
                res = decode_with_fallback(
                    params, arch, enc, decode_text=tokenizer.decode, cfg=cfg,
                    temperatures=temperatures, **(fallback_kw or {}))
            texts.extend(res.texts[: len(batch)])
    else:
        if transcribe_fn is None:
            transcribe_fn = make_transcribe_fn(arch, cfg, device=device)
        texts = []
        for i in range(0, len(chunks), batch_size):
            batch = chunks[i: i + batch_size]
            buf = np.zeros((batch_size, n_samples), np.float32)
            for j, c in enumerate(batch):
                buf[j, : len(c)] = c
            tokens, lengths = transcribe_fn(params, torch.from_numpy(buf))[:2]
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            for j in range(len(batch)):
                texts.append(tokenizer.decode(tokens[j, : lengths[j]]))
    return {
        "text": " ".join(t for t in texts if t),
        "chunks": texts,
        "audio_seconds": len(wav) / 16000.0,
        "num_chunks": len(chunks),
    }


def segments_from_tokens(arch: WhisperArch,
                         gen: np.ndarray) -> tuple[list[dict], float | None]:
    """Parse a generated token stream (timestamp rules on) into segments
    [{"start", "end", "tokens", "tok_idx"}], times in seconds relative to
    the window ("tok_idx": each text token's position in `gen`, to align
    logprob traces), and the seek in seconds (None: a full window).

    OpenAI transcribe() / HF `_retrieve_segment` token for token:
    * a segment ends at a CONSECUTIVE timestamp pair; the stream is cut
      after the pair's first token;
    * a single-timestamp ending ([..., text, ts]) closes the final segment
      there, and the caller advances a full window;
    * a pair ending seeks to the pair's timestamp;
    * no pair at all: one segment anchored at the window start (0.0),
      ending at the last timestamp when there is one (and it is not
      <|0.00|>), else end=None; a full-window advance.
    Segments with no text token are dropped from the list (their bounds
    still count in the seek)."""
    from ..models.decode import timestamp_token_to_seconds as _tts

    ts_begin = arch.no_timestamps_token_id + 1
    toks: list[int] = []
    for t in np.asarray(gen).tolist():
        if int(t) == arch.eos_token_id:
            break
        toks.append(int(t))
    if not toks:
        return [], None
    mask = [t >= ts_begin for t in toks]
    single_ending = len(toks) >= 2 and mask[-2:] == [False, True]
    pairs = [i + 1 for i in range(len(toks) - 1) if mask[i] and mask[i + 1]]

    def _seg(lo: int, hi: int, end_idx: int) -> dict:
        text = [(i, t) for i, t in enumerate(toks[lo:hi], lo) if not mask[i]]
        return {"start": _tts(arch, toks[lo]), "end": _tts(arch, toks[end_idx]),
                "tokens": [t for _, t in text], "tok_idx": [i for i, _ in text]}

    segments: list[dict] = []
    if pairs:
        slices = list(pairs)
        if single_ending:
            slices.append(len(toks))
        else:
            slices[-1] += 1
        lo = 0
        for n, cur in enumerate(slices):
            is_last = n == len(slices) - 1
            end_idx = cur - 1 if (not is_last or single_ending) else cur - 2
            segments.append(_seg(lo, cur, end_idx))
            lo = cur
        seek = None if single_ending else _tts(arch, toks[lo - 2])
    else:
        text = [(i, t) for i, t in enumerate(toks) if not mask[i]]
        ts_vals = [t for t, m in zip(toks, mask) if m]
        end = (_tts(arch, ts_vals[-1])
               if ts_vals and ts_vals[-1] != ts_begin else None)
        segments = [{"start": 0.0, "end": end, "tokens": [t for _, t in text],
                     "tok_idx": [i for i, _ in text]}]
        seek = None
    return [s for s in segments if s["tokens"]], seek


def _parse_clips(clip_timestamps, total_s: float) -> list[tuple[float, float]]:
    """OpenAI `clip_timestamps`: a comma string or a list of start,end,...
    seconds; a missing final end means the end of the audio. Returns the
    in-bounds (start, end) pairs; None, "", "0" or 0 select the whole file."""
    if clip_timestamps in (None, "", "0", 0):
        return [(0.0, total_s)]
    if isinstance(clip_timestamps, str):
        vals = [float(x) for x in clip_timestamps.split(",") if x.strip()]
    else:
        vals = [float(x) for x in clip_timestamps]
    if not vals:
        return [(0.0, total_s)]
    if len(vals) % 2 == 1:
        vals.append(total_s)
    clips = []
    for i in range(0, len(vals), 2):
        s, e = max(0.0, vals[i]), min(vals[i + 1], total_s)
        if e > s:
            clips.append((s, e))
    if not clips:
        raise ValueError(f"clip_timestamps {clip_timestamps!r} selects no "
                         f"audio (duration {total_s:.2f}s)")
    return clips


def _word_anomaly_score(w: dict) -> float:
    """Per-word hallucination evidence (OpenAI whisper/transcribe.py
    word_anomaly_score): improbable tokens, impossibly short or
    suspiciously long durations."""
    score = 0.0
    if w.get("probability", 1.0) < 0.15:
        score += 1.0
    dur = w["end"] - w["start"]
    if dur < 0.133:
        score += (0.133 - dur) * 15.0
    if dur > 2.0:
        score += dur - 2.0
    return score


def _is_segment_anomaly(seg_words: list[dict] | None) -> bool:
    """A segment looks hallucinated: a high anomaly score over its first 8
    words (OpenAI is_segment_anomaly)."""
    if not seg_words:
        return False
    ws = seg_words[:8]
    score = sum(_word_anomaly_score(w) for w in ws)
    return score >= 3.0 or score + 0.01 >= len(ws)


def _segment_words(seg: dict, words: list[dict]) -> list[dict]:
    """Words whose midpoint falls inside the segment's time span."""
    end = seg["end"] if seg["end"] is not None else float("inf")
    return [w for w in words
            if seg["start"] - 0.1 <= 0.5 * (w["start"] + w["end"]) < end]


def apply_hallucination_rules(segments: list[dict], words: list[dict],
                              t0: float, window_end: float, threshold: float,
                              last_speech_end: float = 0.0
                              ) -> tuple[list[dict], list[dict], float | None]:
    """OpenAI's `hallucination_silence_threshold` policy for one decoded
    window: a segment that looks hallucinated and is surrounded by more
    than `threshold` seconds of silence is dropped, and decoding seeks past
    the silence. Times are absolute seconds. Returns (kept segments, kept
    words, seek override: an absolute time to continue from, or None for
    the caller's default advance)."""
    by_seg = [(s, _segment_words(s, words)) for s in segments]
    with_words = [(s, ws) for s, ws in by_seg if ws]

    # 1. leading silence before a hallucinated first segment: skip the
    #    silence and re-decode from the first word
    if with_words:
        first_seg, first_ws = with_words[0]
        gap = first_ws[0]["start"] - t0
        if _is_segment_anomaly(first_ws) and gap > threshold:
            return [], [], first_ws[0]["start"]

    # 2. a hallucinated segment surrounded by silence: drop it (and what
    #    follows) and seek just past its start
    hal_last_end = last_speech_end
    for i, (seg, ws) in enumerate(with_words):
        if _is_segment_anomaly(ws):
            nxt = with_words[i + 1] if i + 1 < len(with_words) else None
            next_start = nxt[1][0]["start"] if nxt else window_end
            silence_before = (seg["start"] - hal_last_end > threshold
                              or seg["start"] < threshold
                              or seg["start"] - t0 < 2.0)
            silence_after = (next_start - (seg["end"] or window_end) > threshold
                             or (nxt is not None and _is_segment_anomaly(nxt[1]))
                             or window_end - (seg["end"] or window_end) < 2.0)
            if silence_before and silence_after:
                seek = max(t0 + 1.0, seg["start"])
                if seg["end"] is not None and window_end - seg["end"] < threshold:
                    seek = window_end  # a hallucination at the content's end
                cut = seg["start"]
                kept_s = [s for s, _ in by_seg if s["start"] < cut and s is not seg]
                kept_w = [w for w in words if 0.5 * (w["start"] + w["end"]) < cut]
                return kept_s, kept_w, seek
        hal_last_end = seg["end"] if seg["end"] is not None else hal_last_end

    # 3. a long trailing silence after the last word: continue from the last
    #    word, not the window end
    if words:
        last_word_end = max(w["end"] for w in words)
        if window_end - last_word_end > threshold:
            return segments, words, last_word_end
    return segments, words, None


def _align_window_words(params, arch: WhisperArch, enc_row, win_toks,
                        tokenizer, alignment_heads, piece_len: int,
                        t0: float, token_logprobs=None) -> list[dict]:
    """Word timestamps for one decoded window (shared by transcribe_seek and
    transcribe_seek_batch): cross-attention DTW alignment and word grouping,
    times offset to the absolute `t0` seconds."""
    from ..models import alignment as align_mod

    n_frames = max(1, min(arch.max_source_positions, piece_len // 320))
    times = align_mod.find_alignment(params, arch, enc_row, win_toks,
                                     alignment_heads=alignment_heads,
                                     n_frames=n_frames)
    ts_begin = arch.no_timestamps_token_id + 1
    special = min(arch.eos_token_id, arch.decoder_start_token_id, ts_begin)
    return align_mod.word_timestamps(
        tokenizer, np.asarray(win_toks).tolist(), times,
        special_threshold=special, offset=t0, token_logprobs=token_logprobs)


def _no_speech(params, arch: WhisperArch, enc: torch.Tensor) -> np.ndarray:
    """P(<|nospeech|>) per row of the encoder states, (B,) f32 on the host."""
    from ..models.decode import no_speech_prob

    with torch.inference_mode():
        return no_speech_prob(params, arch, enc).float().cpu().numpy()


def _conditioned_decode(params, arch: WhisperArch, cfg: DecodeConfig,
                        wav: torch.Tensor, prompt: np.ndarray,
                        plen: np.ndarray, token_logprobs: bool) -> tuple:
    """One prompt-conditioned window decode: encoder over the f32 mel, then
    greedy (with the logprob trace when `token_logprobs`) or beam search
    with the prompt window. Returns the decode's tensors."""
    from ..models.decode import beam_decode, greedy_decode

    with torch.inference_mode():
        enc = _encode_wav(params, arch, wav, torch.float32)
        prompt_t = torch.from_numpy(prompt).to(enc.device)
        plen_t = torch.from_numpy(plen).to(enc.device)
        if token_logprobs:
            return greedy_decode(params, arch, enc, cfg, prompt_tokens=prompt_t,
                                 prompt_lens=plen_t, return_token_logprobs=True)
        return beam_decode(params, arch, enc, cfg, prompt_tokens=prompt_t,
                           prompt_lens=plen_t)


def _segment_with_meta(seg: dict, t0: float, text: str, token_lps_row,
                       first_gen: int, no_speech: float | None) -> dict:
    """One output segment with OpenAI's per-segment metadata: avg_logprob
    (the mean greedy logprob of the segment's text tokens; None without a
    trace), compression_ratio (zlib on the text), no_speech_prob (the
    window's P(<|nospeech|>); None without the encoder output)."""
    from ..models.fallback import compression_ratio

    avg_lp = None
    if token_lps_row is not None and seg.get("tok_idx"):
        avg_lp = float(np.mean([token_lps_row[first_gen + j] for j in seg["tok_idx"]]))
    return {
        "start": t0 + seg["start"],
        "end": None if seg["end"] is None else t0 + seg["end"],
        "text": text,
        "tokens": [int(t) for t in seg["tokens"]],
        "avg_logprob": avg_lp,
        "compression_ratio": compression_ratio(text),
        "no_speech_prob": no_speech,
        "temperature": 0.0,   # overridden by the seek fallback ladder
    }


def transcribe_seek(params, arch: WhisperArch, wav: np.ndarray, tokenizer,
                    cfg: DecodeConfig | None = None, transcribe_fn=None,
                    word_timestamps: bool = False, alignment_heads=None,
                    clip_timestamps=None,
                    hallucination_silence_threshold: float | None = None,
                    temperatures: tuple[float, ...] | None = None,
                    fallback_kw: dict | None = None,
                    condition_on_previous: bool = False,
                    prompt_window: int = 64,
                    initial_prompt_ids: list | None = None,
                    device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Timestamp-seeking long-form transcription (OpenAI transcribe()
    semantics): decode a 30 s window with the timestamp rules, advance to
    the end of the last complete segment, repeat; a full-window advance
    when no closing timestamp was emitted.

    word_timestamps=True aligns each window's tokens to audio frames
    (`models.alignment`) and adds a "words" list with absolute times.
    clip_timestamps: "start,end,start,end,..." seconds (or a list); only
    those ranges are transcribed, times stay absolute.
    hallucination_silence_threshold (needs word_timestamps): a segment that
    looks hallucinated and is surrounded by more than this many seconds of
    silence is dropped and decoding seeks past the silence; word
    "probability" comes from the greedy logprob trace.
    condition_on_previous: each window's decoder is prompted with the
    rolling tail of the emitted tokens (a `<|startofprev|>` window,
    `prompt_window` wide), seeded by initial_prompt_ids; exclusive with
    temperatures, word_timestamps and an injected transcribe_fn.
    temperatures: the fallback ladder per window; each segment carries the
    window's accepted temperature and avg_logprob. Exclusive with
    hallucination_silence_threshold and an injected transcribe_fn;
    fallback_kw forwards the gate thresholds and best_of.

    Returns {"text", "segments" (absolute times), "num_windows",
    "audio_seconds"[, "words"]}."""
    from ..models.decode import _timestamps_enabled, forced_prefix

    cfg = cfg or DecodeConfig(notimestamps=False)
    if not _timestamps_enabled(arch, cfg):
        raise ValueError("transcribe_seek requires timestamp decoding "
                         "(notimestamps=False and a vocab with timestamp "
                         "tokens); use transcribe_long otherwise")
    hst = hallucination_silence_threshold
    if hst is not None and not word_timestamps:
        raise ValueError("hallucination_silence_threshold requires "
                         "word_timestamps=True (OpenAI semantics)")
    if temperatures is not None:
        if hst is not None:
            raise ValueError("temperatures + hallucination_silence_"
                             "threshold: the fallback ladder has no "
                             "greedy per-token trace to score words")
        if transcribe_fn is not None:
            raise ValueError("temperatures needs its own decode path; "
                             "do not inject transcribe_fn")
        if cfg.beam_size > 1:
            raise ValueError("temperatures + beam_size > 1: the fallback "
                             "ladder decodes greedy/sampling only")
    conditioned = condition_on_previous or bool(initial_prompt_ids)
    if conditioned and (temperatures is not None or word_timestamps
                        or transcribe_fn is not None):
        raise ValueError("condition_on_previous/initial_prompt in seek "
                         "mode is mutually exclusive with temperatures, "
                         "word_timestamps and an injected transcribe_fn")
    device = resolve_device(device)
    n_samples = samples_for_arch(arch)
    # greedy decodes carry the logprob trace: it feeds avg_logprob
    want_lp = (hst is not None) or cfg.beam_size <= 1
    own_fn = transcribe_fn is None
    use_fallback = temperatures is not None
    if own_fn and not use_fallback:
        # our own fn also hands back the encoder output, which saves the
        # alignment a second encoder pass per window
        transcribe_fn = make_transcribe_fn(arch, cfg, token_logprobs=want_lp,
                                           return_enc=word_timestamps,
                                           device=device)
    fn_returns_enc = own_fn and word_timestamps and not use_fallback
    first_gen = len(forced_prefix(arch, cfg))

    pw = 0
    history: list[int] = [int(t) for t in (initial_prompt_ids or [])]
    if conditioned:
        # the prompt shares the position budget with the prefix and the
        # generated tokens
        max_pw = arch.max_target_positions - first_gen - cfg.max_new_tokens - 1
        pw = max(min(int(prompt_window), max_pw), 0)
        if pw < 2:
            pw, conditioned = 0, False

    wav = np.asarray(wav, np.float32)
    clips = _parse_clips(clip_timestamps, len(wav) / 16000.0)
    windows = 0
    all_segments: list[dict] = []
    all_words: list[dict] = []
    last_speech_end = 0.0
    for clip_start, clip_end in clips:
        pos = int(clip_start * 16000)
        clip_end_sample = min(int(clip_end * 16000), len(wav))
        while pos < clip_end_sample:
            buf = np.zeros((1, n_samples), np.float32)
            piece = wav[pos: min(pos + n_samples, clip_end_sample)]
            buf[0, : len(piece)] = piece
            jb = torch.from_numpy(buf)
            token_lps = None
            enc = nsp = win_avg_lp = None
            win_temp = 0.0
            fg = first_gen
            if conditioned:
                if history:
                    prompt, plen = _seed_prompt(history, pw, arch.eos_token_id,
                                                arch.vocab_size)
                else:
                    # no context yet: plen = 0, not a lone <|startofprev|>
                    prompt = np.full((1, pw), arch.eos_token_id, np.int32)
                    plen = np.zeros((1,), np.int32)
                outs = _conditioned_decode(params, arch, cfg, jb, prompt, plen,
                                           cfg.beam_size <= 1)
                tokens, lengths = outs[0].cpu().numpy(), outs[1].cpu().numpy()
                if len(outs) > 2:
                    token_lps = outs[2].cpu().numpy()
                fg = pw + first_gen
            elif use_fallback:
                from ..models.fallback import decode_with_fallback

                with torch.inference_mode():
                    enc = _encode_wav(params, arch, jb, torch.float32)
                    fres = decode_with_fallback(
                        params, arch, enc, decode_text=tokenizer.decode, cfg=cfg,
                        temperatures=temperatures, **(fallback_kw or {}))
                tokens, lengths = fres.tokens, fres.lengths
                win_temp = float(fres.temperatures[0])
                win_avg_lp = float(fres.avg_logprobs[0])
            else:
                outs = transcribe_fn(params, jb)
                tokens, lengths = outs[0].cpu().numpy(), outs[1].cpu().numpy()
                # (tokens, lengths[, lp trace][, enc]): the flags are known
                # for our own fn; an injected fn may append a trace only
                idx = 2
                if want_lp or (not own_fn and len(outs) > idx):
                    if len(outs) > idx:
                        token_lps = outs[idx].float().cpu().numpy()
                        idx += 1
            gen = tokens[0, fg: lengths[0]]
            segments, seek_s = segments_from_tokens(arch, gen)
            t0 = pos / 16000.0
            if word_timestamps:
                if enc is None:
                    enc = (outs[idx] if fn_returns_enc
                           else _encode_wav(params, arch, jb, torch.float32))
                nsp = float(_no_speech(params, arch, enc)[0])
            lp_row = None if token_lps is None else token_lps[0]
            win_segments = [_segment_with_meta(s, t0, tokenizer.decode(s["tokens"]),
                                               lp_row, fg, nsp) for s in segments]
            for seg in win_segments:
                # OpenAI stamps the window's accepted temperature (and, under
                # the fallback, its whole-window avg_logprob) on each segment
                seg["temperature"] = win_temp
                if win_avg_lp is not None:
                    seg["avg_logprob"] = win_avg_lp
            if conditioned:
                if condition_on_previous:
                    # every generated token joins the rolling prompt context;
                    # a bounded tail is kept
                    history.extend(int(t) for t in gen.tolist()
                                   if int(t) != arch.eos_token_id)
                    history = history[-4 * pw:]
                else:
                    # initial_prompt alone prompts only the FIRST window
                    history = []
            win_words: list[dict] = []
            if word_timestamps:
                win_words = _align_window_words(
                    params, arch, enc, tokens[0, : lengths[0]], tokenizer,
                    alignment_heads, len(piece), t0,
                    token_logprobs=(None if token_lps is None
                                    else token_lps[0, : lengths[0]]))
            windows += 1
            seek_override = None
            if hst is not None:
                window_end = t0 + len(piece) / 16000.0
                win_segments, win_words, seek_override = apply_hallucination_rules(
                    win_segments, win_words, t0, window_end, hst, last_speech_end)
            all_segments.extend(win_segments)
            all_words.extend(win_words)
            if win_words:
                last_speech_end = max(w["end"] for w in win_words)
            if seek_override is not None:
                # skip the detected silence or hallucination; at least 0.1 s
                pos = max(int(seek_override * 16000), pos + 1600)
                continue
            advance = n_samples if seek_s is None else int(seek_s * 16000)
            pos += max(advance, 1)  # never stall
            if len(piece) < n_samples:
                break  # the final (padded) window consumed the clip
    out = {
        "text": " ".join(s["text"] for s in all_segments if s["text"]),
        "segments": [dict(s, id=i) for i, s in enumerate(all_segments)],
        "num_windows": windows,
        "audio_seconds": len(wav) / 16000.0,
    }
    if word_timestamps:
        out["words"] = all_words
    return out


def transcribe_seek_batch(params, arch: WhisperArch, wavs, tokenizer,
                          cfg: DecodeConfig | None = None, batch_size: int = 8,
                          transcribe_fn=None, word_timestamps: bool = False,
                          alignment_heads=None, stage_int16: bool = False,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> list[dict]:
    """Multi-stream timestamp-seek transcription.

    Each stream's seek loop is sequential, but nothing couples different
    streams, so every iteration takes the next window of up to `batch_size`
    unfinished streams, decodes them in one call of a fixed-batch
    transcription function, and advances each stream's seek on its own. The
    rows no stream fills are zeros (silence).

    The streams are staged on `device` once, as one (N, longest + window)
    pool right-padded with a window of zeros (int16 with `stage_int16`:
    2 bytes a sample, exact for PCM16-sourced audio), and each iteration's
    window batch is cut there from the seek offsets (`_cut_windows`): the
    host sends no audio after the staging.

    Per-stream results equal `transcribe_seek`'s (each batch row decodes
    on its own). Word timestamps: the batch's encoder output and a DTW per
    row; for `hallucination_silence_threshold` use `transcribe_seek`.

    Returns one result dict per input waveform, in order."""
    from ..models.decode import _timestamps_enabled, forced_prefix

    cfg = cfg or DecodeConfig(notimestamps=False)
    if not _timestamps_enabled(arch, cfg):
        raise ValueError("transcribe_seek_batch requires timestamp decoding "
                         "(notimestamps=False and a vocab with timestamp "
                         "tokens)")
    device = resolve_device(device)
    n_samples = samples_for_arch(arch)
    own_fn = transcribe_fn is None
    own_lp = own_fn and cfg.beam_size <= 1   # the greedy trace: avg_logprob
    if own_fn:
        transcribe_fn = make_transcribe_fn(arch, cfg, token_logprobs=own_lp,
                                           return_enc=word_timestamps,
                                           device=device)
    fn_returns_enc = own_fn and word_timestamps
    first_gen = len(forced_prefix(arch, cfg))

    wavs = [np.asarray(w, np.float32) for w in wavs]
    n = len(wavs)
    pos = [0] * n
    done = [len(w) == 0 for w in wavs]
    segs: list[list[dict]] = [[] for _ in range(n)]
    words: list[list[dict]] = [[] for _ in range(n)]
    win_count = [0] * n

    max_len = max((len(w) for w in wavs), default=0)
    stage_dt = np.int16 if stage_int16 else np.float32
    pool = np.zeros((n, max_len + n_samples), stage_dt)
    for i, w in enumerate(wavs):
        if stage_int16:
            pool[i, : len(w)] = np.clip(w * 32767.0, -32768, 32767).astype(np.int16)
        else:
            pool[i, : len(w)] = w
    pool = torch.from_numpy(pool).to(device)

    while not all(done):
        rows = [s for s in range(n) if not done[s]][:batch_size]
        piece_len = {s: min(len(wavs[s]) - pos[s], n_samples) for s in rows}
        buf = _cut_windows(pool, [(s, pos[s]) for s in rows], batch_size, n_samples)
        outs = transcribe_fn(params, buf)   # (tokens, lengths[, lp][, enc])
        tokens, lengths = outs[0].cpu().numpy(), outs[1].cpu().numpy()
        token_lps = outs[2].float().cpu().numpy() if own_lp else None
        enc = None
        if word_timestamps:
            # the encoder output of the decode, reused for the DTW
            enc = (outs[-1] if fn_returns_enc
                   else _encode_wav(params, arch, buf, torch.float32))
        nsp_rows = _no_speech(params, arch, enc) if word_timestamps else None
        for r, s in enumerate(rows):
            gen = tokens[r, first_gen: lengths[r]]
            window_segs, seek_s = segments_from_tokens(arch, gen)
            t0 = pos[s] / 16000.0
            nsp = None if nsp_rows is None else float(nsp_rows[r])
            lp_row = None if token_lps is None else token_lps[r]
            for seg in window_segs:
                segs[s].append(_segment_with_meta(
                    seg, t0, tokenizer.decode(seg["tokens"]), lp_row, first_gen, nsp))
            if word_timestamps:
                words[s].extend(_align_window_words(
                    params, arch, enc[r: r + 1], tokens[r, : lengths[r]],
                    tokenizer, alignment_heads, piece_len[s], t0))
            win_count[s] += 1
            advance = n_samples if seek_s is None else int(seek_s * 16000)
            pos[s] += max(advance, 1)
            if piece_len[s] < n_samples or pos[s] >= len(wavs[s]):
                done[s] = True

    out = []
    for s in range(n):
        res = {
            "text": " ".join(x["text"] for x in segs[s] if x["text"]),
            "segments": [dict(x, id=i) for i, x in enumerate(segs[s])],
            "num_windows": win_count[s],
            "audio_seconds": len(wavs[s]) / 16000.0,
        }
        if word_timestamps:
            res["words"] = words[s]
        out.append(res)
    return out


def _seed_prompt(ids: list, pw: int, eot: int,
                 vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """Right-aligned (1, pw) prompt window [<|startofprev|>] + the trailing
    ids (OpenAI keeps the last n_ctx // 2 - 1 prompt tokens; here the
    window is pw), and its length (1,)."""
    ids = [int(t) for t in ids if 0 <= int(t) < vocab]
    ids = list(ids[-(pw - 1):]) if pw > 1 else []
    if SOT_PREV < vocab:
        ids = [SOT_PREV] + ids
    ids = ids[-pw:]
    prompt = np.full((1, pw), eot, np.int32)
    if ids:
        prompt[0, pw - len(ids):] = ids
    return prompt, np.asarray([len(ids)], np.int32)


def _transcribe_conditioned(params, arch: WhisperArch, chunks, tokenizer,
                            cfg: DecodeConfig, n_samples: int, pw: int,
                            seed_ids: list | None = None) -> list[str]:
    """Chunks decoded one by one, each prompted with the previous chunk's
    generated tokens (the first with `seed_ids`, or an empty window), by
    `beam_decode` (greedy at beam_size <= 1) with the prompt window."""
    from ..models.decode import forced_prefix

    first_gen = pw + len(forced_prefix(arch, cfg))
    eot = arch.eos_token_id
    texts: list[str] = []
    if seed_ids:
        # OpenAI initial_prompt: its tokens precede the first window's prefix
        prompt, plen = _seed_prompt(seed_ids, pw, eot, arch.vocab_size)
    else:
        prompt = np.full((1, pw), eot, np.int32)
        plen = np.zeros((1,), np.int32)
    for chunk in chunks:
        buf = np.zeros((1, n_samples), np.float32)
        buf[0, : len(chunk)] = chunk
        tokens, lengths = _conditioned_decode(params, arch, cfg, torch.from_numpy(buf),
                                              prompt, plen, False)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        gen = tokens[0, first_gen: lengths[0]]
        gen = gen[gen != eot]
        texts.append(tokenizer.decode(gen))
        # the next prompt: <|startofprev|> + the trailing generated tokens
        prompt, plen = _seed_prompt(list(gen), pw, eot, arch.vocab_size)
    return texts
