"""Serving + speculative decoding walkthrough on the PyTorch port.

Shows the two serving-grade surfaces:
- `serving.TranscriptionService`: dynamic batching in front of ONE
  transcribe function (pad-to-batch, native threaded loader, occupancy/RTFx
  stats);
- `models.speculative`: a draft model proposes tokens, the target verifies
  them in one windowed pass — output is bit-exact vs target-only greedy;
- word-level timestamps via cross-attention DTW alignment.

Runs fully offline (random weights + synthetic audio), on the card unless
`--device cpu` says otherwise:

    python examples_torch/serving_and_speculative.py [--model test2l] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="test2l")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card by default, or cpu")
    args = ap.parse_args(argv)

    from openai_whisper_compression_tpu_torch import load_model
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_speculative_transcribe_fn, make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.models import alignment
    from openai_whisper_compression_tpu_torch.models import params as P
    from openai_whisper_compression_tpu_torch.models.fallback import decode_with_fallback
    from openai_whisper_compression_tpu_torch.models.whisper import encode
    from openai_whisper_compression_tpu_torch.serving import TranscriptionService

    dev = args.device
    params, arch = load_model(args.model, device=dev)
    tok = default_tokenizer(arch)
    cfg = DecodeConfig(max_new_tokens=8, language_token_id=None,
                       task_token_id=None)
    rng = np.random.default_rng(0)
    n = samples_for_arch(arch)
    out: dict = {"requests": []}

    # ---- 1. dynamic-batching service
    print("== TranscriptionService (dynamic batching) ==")
    svc = TranscriptionService(params, arch, tok, cfg, batch_size=4,
                               max_wait_ms=25, device=dev)
    futs = [svc.submit(rng.standard_normal(int(n * f)).astype(np.float32) * 0.1)
            for f in (0.3, 0.6, 1.0)]
    for i, f in enumerate(futs):
        r = f.result(timeout=300)
        out["requests"].append({"audio_seconds": r["audio_seconds"],
                                "tokens": list(r["tokens"]),
                                "latency_s": r["latency_s"]})
        print(f"  req{i}: {r['audio_seconds']:.1f}s audio -> "
              f"{len(r['tokens'])} tokens, latency {r['latency_s']*1e3:.0f} ms")
    svc.close()
    out["stats"] = {k: round(v, 3) if isinstance(v, float) else v
                    for k, v in svc.stats.snapshot().items()}
    print("  stats:", out["stats"])

    # ---- 2. speculative decoding (draft = 1-layer shrink of the target)
    print("== Speculative decoding ==")
    arch_d = arch.replace(name="draft", encoder_layers=1, decoder_layers=1)
    params_d = P.init_params(arch_d, 7, device=dev)
    wav = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    tg, lg = make_transcribe_fn(arch, cfg, device=dev)(params, wav)
    ts, _ = make_speculative_transcribe_fn(arch, arch_d, cfg, gamma=3, device=dev)(
        params, params_d, wav)
    tg, lg, ts = tg.cpu().numpy(), lg.cpu().numpy(), ts.cpu().numpy()
    m = int(lg.min())
    out["speculative_exact"] = bool(np.array_equal(tg[:, :m], ts[:, :m]))
    print(f"  speculative == greedy: {out['speculative_exact']}")

    # ---- 3. word-level timestamps (cross-attention DTW)
    print("== Word-level timestamps ==")
    with torch.inference_mode():
        enc = encode(params, arch, torch.zeros(
            1, arch.num_mel_bins, 2 * arch.max_source_positions, device=dev))
    toks = tg[0, : int(lg[0])]
    times = alignment.find_alignment(params, arch, enc, toks)
    words = alignment.word_timestamps(
        tok, toks.tolist(), times,
        special_threshold=min(arch.eos_token_id, arch.decoder_start_token_id))
    out["words"] = [(w["start"], w["end"], w["word"]) for w in words[:5]]
    for w in words[:5]:
        print(f"  {w['start']:5.2f}-{w['end']:5.2f}  {w['word']}")

    # ---- 4. temperature-fallback decoding (OpenAI quality gates)
    print("== Temperature fallback ==")
    res = decode_with_fallback(
        params, arch, enc, decode_text=tok.decode, cfg=cfg,
        temperatures=(0.0, 0.2, 0.4), no_speech_threshold=0.9)
    out["fallback"] = []
    for i in range(min(2, len(res.texts))):
        out["fallback"].append((res.temperatures[i], res.avg_logprobs[i],
                                res.compression_ratios[i], bool(res.is_silent[i])))
        print(f"  T={res.temperatures[i]:.1f} lp={res.avg_logprobs[i]:.2f} "
              f"cr={res.compression_ratios[i]:.2f} "
              f"silent={bool(res.is_silent[i])}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
