"""Compression-recovery walkthrough on the PyTorch port: PTQ vs recovery
distillation vs QAT.

The reference's pipeline is one-shot — quantize, measure WER, done
(`quantization.py:42-90`); at int2 that collapses. This example shows the
recovery ladder on a tiny model, fully offline (random weights, synthetic
audio; the teacher IS the label, so no transcripts are needed), on the
card unless `--device cpu` says otherwise:

  1. PTQ:      quantize_params(model, "int2")                (one-shot)
  2. recover:  PTQ -> dequantize -> KL-distill -> requantize (repairs
               the current rounding error)
  3. QAT:      every training forward runs on STE-fake-quantized weights
               (bit-identical to deployment), so the latent weights LEARN
               to sit on the quantizer grid

and compares each rung's fidelity against the dense baseline with the
agreement harness (token agreement / logit KL — the offline stand-in for
WER deltas).

    python examples_torch/qat_recovery.py [--model test2l] [--steps 40] [--device cpu]
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
    ap.add_argument("--hf", default=None)
    ap.add_argument("--method", default="int2")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card by default, or cpu")
    args = ap.parse_args(argv)

    from openai_whisper_compression_tpu_torch import load_model
    from openai_whisper_compression_tpu_torch.distill import fake_quant_recovery
    from openai_whisper_compression_tpu_torch.evaluation.agreement import model_agreement
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params
    from openai_whisper_compression_tpu_torch.quant.qat import qat_distill

    teacher, arch = load_model(args.model, hf=args.hf, device=args.device)
    mels = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (2, arch.num_mel_bins, 2 * arch.max_source_positions)) * 0.1).astype(np.float32)
    ).to(args.device)
    out: dict = {}

    def fidelity(tag, params_q):
        r = model_agreement(teacher, params_q, arch, mels)
        print(f"{tag:12s} token_agreement={r['token_agreement']:.3f} "
              f"mean_kl={r['mean_kl']:.4f} "
              f"logit_rel_err={r['logit_rel_err']:.4f}")
        out[tag] = r
        return r

    print(f"# {arch.name} {args.method}, {args.steps} recovery steps")
    ptq = quantize_params(teacher, args.method)
    r_ptq = fidelity("ptq", ptq)

    rec = fake_quant_recovery(ptq, teacher, arch, method=args.method,
                              steps=args.steps, lr=args.lr)
    fidelity("recover", rec)

    qat, hist = qat_distill(teacher, teacher, arch, method=args.method,
                            steps=args.steps, lr=args.lr,
                            preserve_sparsity=False)
    out["qat_loss"] = [float(x) for x in hist]
    print(f"# qat loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    r_qat = fidelity("qat", qat)

    if not r_qat["mean_kl"] <= r_ptq["mean_kl"]:
        raise AssertionError("QAT should not lose to one-shot PTQ on its own objective")
    print("OK")
    return out


if __name__ == "__main__":
    main()
