"""Evaluation engine: warmup, batched transcription, WER/CER/RTF roll-up.

The port of the JAX package's `evaluation/harness.py`:
`make_transcribe_fn` builds the end-to-end function (log-mel frontend,
fused mel kernel; encoder; `models.decode.greedy_decode`, or `beam_decode`
when `cfg.beam_size > 1`), plain Python around the kernels under inference
mode, as PyTorch runs eagerly. `evaluate_model` drives it over a dataset:
warmup batches, length bucketing, the text normalizer, per-utterance records
in input order, corpus WER/CER, RTF = processing s / audio s and RTFx (its
inverse), per-batch latency, and the memory roll-up. `transcribe_batch`
times one batch from the moment its waveforms are on the device to the host
readback of its tokens and lengths, so the window holds all of the device's
work and the host loop that drives it (the JAX package times one jitted
call with a host readback). `make_calibration_fn` runs the teacher-forced
`models.whisper.forward` over a fixed batch; `make_speculative_transcribe_fn`
the speculative decode of `models.speculative` with a draft model.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..audio import features
from ..config import HOP_LENGTH, DecodeConfig, EvalConfig, WhisperArch
from ..models.decode import beam_decode, check_supported, greedy_decode
from ..models.params import DEFAULT_DEVICE, resolve_device
from ..models.whisper import encode, forward
from . import metrics
from .data import Utterance, batch_iterator
from .memory import MemoryTracker

logger = logging.getLogger("whisper_eval")


def samples_for_arch(arch: WhisperArch) -> int:
    """Waveform samples the encoder consumes: max_source_positions frames
    after the stride-2 conv (480_000 for the real Whisper family)."""
    return arch.max_source_positions * 2 * HOP_LENGTH


def _tree_dtype(params) -> torch.dtype:
    return params["encoder"]["ln"]["g"].dtype


def make_calibration_fn(arch: WhisperArch, cal: Sequence[Utterance],
                        tokenizer=None, batch_size: int = 4,
                        n_tokens: int = 8,
                        device: str | torch.device = DEFAULT_DEVICE):
    """Calibration callable for data-aware quantizers: each call runs one
    teacher-forced `forward` over a fixed batch of at most `batch_size`
    utterances (f32 DFT mel in the tree's dtype) and returns its logits
    (B, n_tokens, vocab) (the JAX function returns nothing). Decoder tokens
    are <|sot|> then the tokenized reference text when a tokenizer is given
    (teacher forcing), padded with EOT. `params` must live on `device`."""
    cal = list(cal)[: max(int(batch_size), 1)]
    if not cal:
        raise ValueError("data-aware calibration needs >= 1 utterance")
    device = resolve_device(device)
    n_samples = samples_for_arch(arch)
    wavs = np.zeros((len(cal), n_samples), np.float32)
    for i, u in enumerate(cal):
        a = np.asarray(u.audio, np.float32)[:n_samples]
        wavs[i, : len(a)] = a
    toks = np.full((len(cal), n_tokens), arch.eos_token_id, np.int64)
    toks[:, 0] = arch.decoder_start_token_id
    if tokenizer is not None:
        for i, u in enumerate(cal):
            ids = [t for t in tokenizer.encode(u.text)
                   if t < arch.vocab_size][: n_tokens - 1]
            toks[i, 1: 1 + len(ids)] = ids
    wavs_t = torch.from_numpy(wavs).to(device)
    toks_t = torch.from_numpy(toks).to(device)

    def run_cal(params):
        mel = features.preprocess(wavs_t, n_mels=arch.num_mel_bins,
                                  length=n_samples)
        return forward(params, arch, mel.to(_tree_dtype(params)), toks_t)

    return run_cal


def make_transcribe_fn(arch: WhisperArch, cfg: DecodeConfig,
                       n_mels: int | None = None,
                       fast_mel: bool = False, merge_at: int | None = None,
                       merge_factor: int = 2, fast_gelu: bool = False,
                       token_logprobs: bool = False, return_enc: bool = False,
                       device: str | torch.device = DEFAULT_DEVICE):
    """Build fn(params, wav) -> (tokens (B, L), lengths (B,)) running on
    `device` (the card unless the caller names another; with no card a
    CUDA device raises here). n_mels: mel bins (the arch's by default);
    fast_mel: bf16 DFT operands (f32 sums); merge_at / merge_factor: the
    encoder's adjacent-token merging (`models.whisper.encode`); fast_gelu:
    tanh-approximate GELU in the encoder MLPs; token_logprobs: append the
    greedy per-position logprob trace (B, L) to the outputs (greedy only);
    return_enc: append the encoder output last, for alignment consumers.
    `params` must already live on `device`; `wav` (B, T) f32 may be a numpy
    array or a tensor anywhere."""
    if token_logprobs and cfg.beam_size > 1:
        raise ValueError("token_logprobs is only available for greedy "
                         "decoding (beam_size == 1)")
    check_supported(arch, cfg)
    device = resolve_device(device)
    n_mels = n_mels or arch.num_mel_bins
    n_samples = samples_for_arch(arch)
    dft_dtype = torch.bfloat16 if fast_mel else torch.float32

    @torch.inference_mode()
    def fn(params, wav):
        if isinstance(wav, np.ndarray):
            wav = torch.from_numpy(wav)
        wav = wav.to(device=device, dtype=torch.float32)
        mel = features.preprocess(wav, n_mels=n_mels, length=n_samples,
                                  dft_dtype=dft_dtype)
        enc = encode(params, arch, mel.to(_tree_dtype(params)),
                     merge_at=merge_at, merge_factor=merge_factor,
                     fast_gelu=fast_gelu)
        if cfg.beam_size > 1:
            out = beam_decode(params, arch, enc, cfg)
        else:
            out = greedy_decode(params, arch, enc, cfg,
                                return_token_logprobs=token_logprobs)
        return out + (enc,) if return_enc else out

    return fn


def make_speculative_transcribe_fn(arch_t: WhisperArch, arch_d: WhisperArch,
                                   cfg: DecodeConfig, gamma: int = 4,
                                   fast_mel: bool = False,
                                   fast_gelu: bool = False,
                                   device: str | torch.device = DEFAULT_DEVICE):
    """Speculative transcription on `device`: fn(params_target,
    params_draft, wav) -> (tokens, lengths), the target-only greedy output
    (`models.speculative.speculative_decode`). Each model runs its own mel
    (at its own `num_mel_bins`) and encoder, e.g. a whisper-tiny draft for
    a whisper-small target. Both trees must live on `device`."""
    from ..models.speculative import speculative_decode

    check_supported(arch_t, cfg)
    device = resolve_device(device)
    n_samples = samples_for_arch(arch_t)
    dft_dtype = torch.bfloat16 if fast_mel else torch.float32

    def enc_of(params, arch, wav):
        mel = features.preprocess(wav, n_mels=arch.num_mel_bins, length=n_samples,
                                  dft_dtype=dft_dtype)
        return encode(params, arch, mel.to(_tree_dtype(params)), fast_gelu=fast_gelu)

    @torch.inference_mode()
    def fn(params_t, params_d, wav):
        if isinstance(wav, np.ndarray):
            wav = torch.from_numpy(wav)
        wav = wav.to(device=device, dtype=torch.float32)
        tokens, lengths, _ = speculative_decode(
            params_t, arch_t, params_d, arch_d, enc_of(params_t, arch_t, wav),
            enc_of(params_d, arch_d, wav), cfg, gamma=gamma)
        return tokens, lengths

    return fn


_LOADERS: dict[tuple[int, int], Any] = {}


def _batch_loader(batch_size: int, n_samples: int):
    """Cached native (C++ threaded) batch assembler; numpy fallback inside."""
    from ..runtime_native import BatchLoader

    key = (batch_size, n_samples)
    if key not in _LOADERS:
        _LOADERS[key] = BatchLoader(batch_size, n_samples)
    return _LOADERS[key]


def transcribe_batch(transcribe_fn, params, batch: Sequence[Utterance],
                     tokenizer, batch_size: int,
                     n_samples: int = 30 * 16000) -> tuple[list[str], float]:
    """Pad the utterance batch to `batch_size` rows of `n_samples`, move it
    to the params' device, run `transcribe_fn` and decode to text. Returns
    (texts, seconds): the window opens once the waveforms are on the device
    and closes after the host has read the tokens and lengths back."""
    loader = _batch_loader(batch_size, n_samples)
    for i in range(batch_size):
        if i < len(batch):
            loader.submit(i, batch[i].audio)
        else:
            loader.clear(i)
    wavs = torch.from_numpy(loader.flush()).to(params["encoder"]["ln"]["g"].device)
    t0 = time.perf_counter()
    tokens, lengths = transcribe_fn(params, wavs)[:2]
    tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()  # the fence
    dt = time.perf_counter() - t0
    texts = [tokenizer.decode(tokens[i, : lengths[i]])
             for i in range(len(batch))]
    return texts, dt


def evaluate_model(params, arch: WhisperArch, dataset: list[Utterance],
                   tokenizer, eval_cfg: EvalConfig | None = None,
                   decode_cfg: DecodeConfig | None = None,
                   memory_tracker: MemoryTracker | None = None,
                   transcribe_fn=None,
                   device: str | torch.device = DEFAULT_DEVICE
                   ) -> tuple[dict[str, Any], list[dict]]:
    """Full evaluation loop -> (scores, records), the JAX package's
    contract: warmup batches (the first build of the kernels falls there),
    batched transcription, corpus WER/CER, RTF = processing s / audio s,
    RTFx = audio s / processing s, per-batch latency (each batch's in
    `batch_latencies_s`, the first apart from the rest) and memory. Without
    a `transcribe_fn`, `make_transcribe_fn(arch, decode_cfg, device=device)`
    runs; `params` must live on its device. A tracker reads the memory of
    the params' device; the analytic footprint stands in where that device
    reports none (the CPU)."""
    eval_cfg = eval_cfg or EvalConfig()
    decode_cfg = decode_cfg or DecodeConfig()
    bs = eval_cfg.batch_size
    n_samples = samples_for_arch(arch)
    if transcribe_fn is None:
        transcribe_fn = make_transcribe_fn(arch, decode_cfg, device=device)
    if memory_tracker is not None:
        memory_tracker.device = params["encoder"]["ln"]["g"].device
        if memory_tracker.analytic_mb is None:
            ckv = (0.5 if decode_cfg.cross_kv_int4
                   else 1.0 if decode_cfg.cross_kv_int8 else 2.0)
            memory_tracker.set_analytic(
                params, arch, bs, beam=decode_cfg.beam_size,
                kv_int8=decode_cfg.kv_int8, cross_kv_bytes=ckv,
                cache_len=-(-(decode_cfg.max_new_tokens + 8) // 64) * 64,
                audio_resident=True)

    if eval_cfg.warmup_batches and dataset:
        warm = dataset[:bs]
        for _ in range(eval_cfg.warmup_batches):
            transcribe_batch(transcribe_fn, params, warm, tokenizer, bs,
                             n_samples)

    norm = metrics.resolve_normalizer(getattr(eval_cfg, "normalizer", "basic"))
    normalize = norm is not None
    # length bucketing: similar durations share a lockstep batch; a stable
    # sort, records restored to input order below (corpus WER does not
    # depend on the order)
    input_order = None
    if getattr(eval_cfg, "length_bucketing", False) and len(dataset) > bs:
        input_order = {u.uid: i for i, u in enumerate(dataset)}
        dataset = sorted(dataset, key=lambda u: u.duration)
    refs: list[str] = []
    hyps: list[str] = []
    records: list[dict] = []
    total_proc = 0.0
    total_audio = 0.0
    batch_rtfs: list[float] = []
    batch_latencies: list[float] = []

    for bi, batch in enumerate(batch_iterator(dataset, bs)):
        texts, dt = transcribe_batch(transcribe_fn, params, batch, tokenizer,
                                     bs, n_samples)
        audio_dur = sum(u.duration for u in batch)
        total_proc += dt
        total_audio += audio_dur
        batch_rtfs.append(dt / max(audio_dur, 1e-9))
        batch_latencies.append(dt)
        for utt, hyp in zip(batch, texts):
            refs.append(utt.text)
            hyps.append(hyp)
            records.append({"id": utt.uid, "reference": utt.text,
                            "hypothesis": hyp, "duration": utt.duration,
                            "wer": metrics.per_sample_wer(
                                utt.text, hyp, normalize, norm)})
        if memory_tracker is not None:
            memory_tracker.log_memory(split=eval_cfg.split, batch_idx=bi,
                                      batch_size=len(batch),
                                      audio_duration=audio_dur, latency=dt)

    if input_order is not None:
        records.sort(key=lambda r: input_order.get(r["id"], 1 << 30))

    def stat(fn, xs):
        return float(fn(xs)) if xs else None

    scores: dict[str, Any] = {
        "num_samples": len(refs),
        "wer": metrics.wer(refs, hyps, normalize, norm) if refs else None,
        "cer": (metrics.cer(refs, hyps, normalize, norm)
                if (refs and eval_cfg.compute_cer) else None),
        "total_processing_time_s": total_proc,
        "total_audio_duration_s": total_audio,
        "rtf": total_proc / max(total_audio, 1e-9),
        "rtfx": total_audio / max(total_proc, 1e-9),
        "avg_latency_per_batch_s": stat(np.mean, batch_latencies),
        "batch_latencies_s": batch_latencies,
        "batch_rtf": {"mean": stat(np.mean, batch_rtfs),
                      "min": stat(np.min, batch_rtfs),
                      "max": stat(np.max, batch_rtfs),
                      "std": stat(np.std, batch_rtfs)},
        "batch_size": bs,
        "split": eval_cfg.split,
        "normalizer": getattr(eval_cfg, "normalizer", "basic"),
    }
    if memory_tracker is not None:
        scores["memory"] = memory_tracker.get_memory_summary()
    return scores, records


def save_evaluation_results(scores: dict, records: list[dict],
                            model_name: str, save_path: str) -> dict[str, str]:
    """JSON artifacts: {model}_results.json with the metrics and
    {model}_transcriptions.json with the records."""
    os.makedirs(save_path, exist_ok=True)
    metrics_path = os.path.join(save_path, f"{model_name}_results.json")
    with open(metrics_path, "w") as f:
        json.dump({"model": model_name, "metrics": scores}, f, indent=2,
                  default=str)
    tr_path = os.path.join(save_path, f"{model_name}_transcriptions.json")
    with open(tr_path, "w") as f:
        json.dump(records, f, indent=2)
    return {"metrics": metrics_path, "transcriptions": tr_path}


def print_evaluation_summary(all_scores: dict[str, dict]) -> str:
    """Console summary table: WER, CER, RTFx and peak device memory per
    configuration."""
    lines = [f"{'config':<40} {'WER':>8} {'CER':>8} {'RTFx':>8} {'HBM peak MB':>12}"]
    for name, s in all_scores.items():
        wer = f"{s['wer']:.4f}" if s.get("wer") is not None else "-"
        cer = f"{s['cer']:.4f}" if s.get("cer") is not None else "-"
        rtfx = f"{s['rtfx']:.2f}" if s.get("rtfx") else "-"
        hbm = "-"
        mem = s.get("memory") or {}
        if mem.get("hbm_peak_mb"):
            hbm = f"{mem['hbm_peak_mb']['max']:.0f}"
        lines.append(f"{name:<40} {wer:>8} {cer:>8} {rtfx:>8} {hbm:>12}")
    out = "\n".join(lines)
    logger.info("\n%s", out)
    print(out)
    return out
