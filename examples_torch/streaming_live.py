"""Live streaming transcription walkthrough on the PyTorch port.

Shows the incremental-decoding surfaces (beyond the reference, which is
offline-only):
- `streaming.StreamingTranscriber`: feed audio as it arrives, read back
  monotonic committed text + a live pending tail (LocalAgreement-n);
- energy-VAD gating: silent stretches cost zero decodes;
- `streaming.StreamingPool`: N concurrent sessions share ONE batched
  decode — the serving-scale configuration.

Runs fully offline (random weights + synthetic audio), on the card unless
`--device cpu` says otherwise:

    python examples_torch/streaming_live.py [--model test2l-ts] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from openai_whisper_compression_tpu_torch import load_model  # noqa: E402
from openai_whisper_compression_tpu_torch.config import DecodeConfig  # noqa: E402
from openai_whisper_compression_tpu_torch.evaluation.harness import (  # noqa: E402
    samples_for_arch)
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import (  # noqa: E402
    default_tokenizer)
from openai_whisper_compression_tpu_torch.streaming import (  # noqa: E402
    StreamingPool, StreamingTranscriber)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="test2l-ts",
                    help="arch name (needs timestamp tokens)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card by default, or cpu")
    args = ap.parse_args(argv)

    dev = args.device
    params, arch = load_model(args.model, device=dev)
    tok = default_tokenizer(arch)
    cfg = DecodeConfig(max_new_tokens=8, language_token_id=None,
                       task_token_id=None, notimestamps=False,
                       max_initial_timestamp_index=20)
    n = samples_for_arch(arch)
    g = np.random.default_rng(0)
    wav = (g.standard_normal(int(args.seconds * 16000)) * 0.1
           ).astype(np.float32)
    wav[: 16000 // 2] = 0.0                       # leading silence
    out: dict = {"single": [], "ticks": []}

    print("== single stream (VAD on) ==")
    st = StreamingTranscriber(params, arch, tok, cfg, min_step_s=0.5,
                              vad_threshold=1e-3, device=dev)
    chunk = max(n // 4, 1600)
    for i in range(0, len(wav), chunk):
        res = st.feed(wav[i: i + chunk])
        out["single"].append((res["committed"], res["pending"]))
        print(f"  t={min((i + chunk), len(wav)) / 16000.0:5.2f}s  "
              f"committed={res['committed']!r}  pending={res['pending']!r}")
    final = st.flush()
    out["single_final"] = (final["committed"], len(final["segments"]))
    print(f"  final: {final['committed']!r} "
          f"({len(final['segments'])} segments)")

    print("== pooled streams (one batched decode per tick) ==")
    pool = StreamingPool(params, arch, tok, cfg, max_streams=4,
                         min_step_s=0.5, device=dev)
    for sid in ("mic-1", "mic-2"):
        pool.open(sid)
    for i in range(0, len(wav), chunk):
        pool.feed("mic-1", wav[i: i + chunk])
        pool.feed("mic-2", wav[len(wav) - i - chunk: len(wav) - i])
        partials = pool.tick()
        out["ticks"].append({sid: p["committed"] for sid, p in partials.items()})
        line = "  ".join(f"{sid}: {p['committed']!r}"
                         for sid, p in sorted(partials.items()))
        print(f"  tick {i // chunk}: {line}")
    out["pool_final"] = {}
    for sid in ("mic-1", "mic-2"):
        out["pool_final"][sid] = pool.close(sid)["committed"]
        print(f"  {sid} final: {out['pool_final'][sid]!r}")
    return out


if __name__ == "__main__":
    main()
