"""End-to-end walkthrough on the PyTorch port: load → analyze → prune →
quantize → verify fidelity → store compressed → reload → transcribe.

Runs fully offline (random weights + synthetic audio), on the card unless
`--device cpu` says otherwise. With a local checkpoint, swap
`load_model("small")` for `load_model(hf="path/to/whisper-small")` and
nothing else changes.

    python examples_torch/compress_store_serve.py [--model tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="test2l")
    ap.add_argument("--hf", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card by default, or cpu")
    args = ap.parse_args(argv)

    from openai_whisper_compression_tpu_torch import load_model, prune, quantize, transcribe
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.agreement import model_agreement
    from openai_whisper_compression_tpu_torch.evaluation.harness import samples_for_arch
    from openai_whisper_compression_tpu_torch.models.params import size_in_mb
    from openai_whisper_compression_tpu_torch.prune.magnitude import sparsity_report
    from openai_whisper_compression_tpu_torch.prune.recipe import DEFAULT_RECIPE
    from openai_whisper_compression_tpu_torch.sensitivity.architecture import (
        analyze_model, format_table)
    from openai_whisper_compression_tpu_torch.storage.formats import (
        load_sparse_zip, verify_roundtrip)

    out: dict = {}
    # 1. load + inspect
    params, arch = load_model(args.model, hf=args.hf, device=args.device)
    out["size_mb"] = size_in_mb(params)
    print(f"== {arch.name}: {out['size_mb']:.1f} MB")
    out["table"] = format_table(analyze_model(params))
    print(out["table"])

    # 2. compress: thesis pruning recipe, then int8 weight-only
    compressed = quantize(prune(params, arch, recipe=DEFAULT_RECIPE), "int8")
    rep = sparsity_report(compressed)
    out["compressed_mb"], out["sparsity"] = size_in_mb(compressed), rep["overall_sparsity"]
    print(f"\n== compressed: {out['compressed_mb']:.1f} MB, "
          f"sparsity {out['sparsity']:.2f}")

    # 3. fidelity vs the dense baseline (offline accuracy gate)
    n = samples_for_arch(arch)
    g = np.random.default_rng(0)
    mels = torch.from_numpy(g.standard_normal(
        (2, arch.num_mel_bins, 2 * arch.max_source_positions)).astype(np.float32)
    ).to(args.device)
    cfg = None
    if arch.vocab_size < 50259:
        cfg = DecodeConfig(max_new_tokens=8, language_token_id=None,
                           task_token_id=None, notimestamps=False)
    agr = model_agreement(params, compressed, arch, mels, decode_cfg=cfg)
    out["token_agreement"], out["mean_kl"] = agr["token_agreement"], agr["mean_kl"]
    print(f"== fidelity: token_agreement={agr['token_agreement']:.3f} "
          f"mean_kl={agr['mean_kl']:.2e}")

    # 4. store + verified reload
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/model.zip"
        res = verify_roundtrip(compressed, path, "sparse_zip")
        out["file_mb"], out["roundtrip_ok"] = res["file_mb"], bool(res["ok"])
        print(f"== stored {path}: {res['file_mb']:.1f} MB on disk, "
              f"roundtrip {'OK' if res['ok'] else 'FAILED'}")
        reloaded = load_sparse_zip(path, device=args.device)

    # 5. serve: long-form transcription through the reloaded model
    wav = (g.standard_normal(int(1.5 * n)) * 0.1).astype(np.float32)
    res = transcribe(reloaded, arch, wav, decode_cfg=cfg, batch_size=2, device=args.device)
    out.update(audio_seconds=res["audio_seconds"], num_chunks=res["num_chunks"],
               text=res["text"])
    print(f"== transcribed {res['audio_seconds']:.1f}s in "
          f"{res['num_chunks']} chunks: {res['text'][:70]!r}")
    return out


if __name__ == "__main__":
    main()
