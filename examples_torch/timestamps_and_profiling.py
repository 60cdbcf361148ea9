"""Timestamp-segmented transcription + per-sample profiling walkthrough on
the PyTorch port.

Shows the two newer surfaces on top of the compression pipeline:
- OpenAI timestamp decoding rules + seek-based long-form transcription
  (`evaluation.longform.transcribe_seek`): segments with start/end times;
- the per-sample eval stack (`evaluation.profiler`): model size breakdown,
  per-utterance WER/CER/latency records, summary metrics, plots (where
  matplotlib is installed; the run says so where it is not).

Runs fully offline (random weights + synthetic audio), on the card unless
`--device cpu` says otherwise:

    python examples_torch/timestamps_and_profiling.py [--model test2l] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="test2l")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card by default, or cpu")
    args = ap.parse_args(argv)

    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.data import synthetic_dataset
    from openai_whisper_compression_tpu_torch.evaluation.longform import transcribe_seek
    from openai_whisper_compression_tpu_torch.evaluation.profiler import (
        ModelProfiler, TranscriptionMetrics, VisualizationUtils, WhisperEvaluator,
        setup_device)
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
    from openai_whisper_compression_tpu_torch.models import params as P

    dev = setup_device(args.device)

    # a tiny arch with a timestamp-token region carved out of the vocab
    # (the real Whisper vocab has this natively: ids > 50363)
    arch = ARCHS[args.model].replace(
        no_timestamps_token_id=ARCHS[args.model].vocab_size - 100)
    params = P.init_params(arch, 0, device=dev)
    tok = WordTokenizer(arch.vocab_size,
                        special_start=arch.no_timestamps_token_id - 3)
    out: dict = {}

    # 1. timestamp-seek long-form transcription
    g = np.random.default_rng(0)
    window = 2 * arch.max_source_positions * 160  # samples per 30s-equiv
    wav = (g.standard_normal(3 * window) * 0.1).astype(np.float32)
    cfg = DecodeConfig(max_new_tokens=12, language_token_id=None,
                       task_token_id=None, notimestamps=False,
                       max_initial_timestamp_index=20)
    res = transcribe_seek(params, arch, wav, tok, cfg, device=dev)
    out.update(audio_seconds=res["audio_seconds"], num_windows=res["num_windows"],
               segments=[(s["start"], s["end"], s["text"]) for s in res["segments"]])
    print(f"== long-form: {res['audio_seconds']:.1f}s audio, "
          f"{res['num_windows']} windows, {len(res['segments'])} segments")
    for s in res["segments"][:5]:
        end = "..." if s["end"] is None else f"{s['end']:.2f}"
        print(f"  [{s['start']:6.2f} -> {end:>6}] {s['text'][:48]}")

    # 2. per-sample evaluation + profiling
    with tempfile.TemporaryDirectory() as tmp:
        prof = ModelProfiler(arch.name, results_dir=tmp)
        prof.get_detailed_model_size(params)
        prof.print_size_analysis(top_k=5)

        ev = WhisperEvaluator(params, arch, tok, prof,
                              DecodeConfig(max_new_tokens=6,
                                           language_token_id=None,
                                           task_token_id=None,
                                           notimestamps=False),
                              device=dev)
        data = synthetic_dataset(4, seed=1, min_dur=1.0, max_dur=2.0)
        records = ev.evaluate_dataset(data)
        summary = TranscriptionMetrics.calculate_summary_metrics(
            records, model_size=prof.measure_model_size(params))
        TranscriptionMetrics.print_summary(summary)
        out["summary"] = summary
        prof.save_metrics("per_sample.csv")
        if importlib.util.find_spec("matplotlib") is None:
            print("# matplotlib is not installed: no plots written")
        else:
            VisualizationUtils.plot_error_distributions(records, f"{tmp}/err.png")
        print("== artifacts written to", tmp)
    return out


if __name__ == "__main__":
    main()
