"""Whether what the timed path served is correct: the comparison with the
plain reference.

For each sampled request, the reference (`reference/whisper_ref.py`, f32,
TF32 off, the weights quantized again from the seed by the frozen rule)
takes the request's waveform as it was sent, and runs its log-mel, its
encoder and its decoder teacher-forced over the configuration's forced
prefix followed by the tokens the program served. At each served position
the gap is the reference's best logit (the suppressed tokens left out, as
the program suppresses them) minus the reference's logit of the token the
program served: 0 where the program chose the reference's best, small
where it chose a near tie, large where it chose a token the model does not
rank near the top. `logit_gap` is the widest gap over every served token
of the sample. It covers the frontend, the encoder, the int8 cross-KV and
self-KV and every decode step that produced a served token.

The control (`control=True`) runs the same reference with its linear
weights rounded to int4, the precision below the configuration's int8, and
reads, at each position of the same prompts and tokens, the reference's gap
of the token the control puts first.
"""

from __future__ import annotations

import gc

import torch

from benchlib import weights as seeded
from reference.whisper_ref import WhisperReference


def _gaps(ref_logits: torch.Tensor, tokens: torch.Tensor, suppress: list[int]) -> torch.Tensor:
    lg = ref_logits.clone()
    lg[:, suppress] = float("-inf")
    return lg.amax(dim=-1) - ref_logits.gather(1, tokens[:, None])[:, 0]


def compare(config: dict, seed: int, served: list, device, control: bool = False,
            block: int = 4) -> dict:
    """{"logit_gap": widest gap of the program's tokens[, "control_gap":
    widest gap of the control's first choices]} over `served`."""
    m = config["model"]
    suppress = [m["eos_token_id"]] if config["program"]["decode"].get("suppress_eot") else []
    prefix = list(m["forced_prefix"])
    gelu = config["program"]["encoder_mlp_gelu"]
    tree = seeded.of_config(config, seed, device)
    refs = {"ref": WhisperReference(m, tree, 8, gelu)}
    if control:
        refs["control"] = WhisperReference(m, tree, 4, gelu)
    del tree
    out = {"logit_gap": 0.0, "tokens_compared": 0}
    if control:
        out["control_gap"] = 0.0
    with torch.no_grad():
        for i in range(0, len(served), block):
            part = [s for s in served[i: i + block] if s.tokens]
            if not part:
                continue
            n = max(len(s.tokens) for s in part)
            wav = torch.zeros(len(part), max(len(s.wav) for s in part), device=device)
            for j, s in enumerate(part):
                wav[j, : len(s.wav)] = torch.as_tensor(s.wav, device=device)
            seqs = torch.tensor([prefix + s.tokens[:-1] + [m["eos_token_id"]] * (n - len(s.tokens))
                                 for s in part], device=device)
            got = {}
            for name, ref in refs.items():
                enc = ref.encode(ref.log_mel(wav))
                got[name] = ref.logits(enc, seqs)[:, len(prefix) - 1:]
                del enc
            for j, s in enumerate(part):
                k = len(s.tokens)
                lg = got["ref"][j, :k]
                toks = torch.tensor(s.tokens, device=device)
                out["logit_gap"] = max(out["logit_gap"], float(_gaps(lg, toks, suppress).max()))
                out["tokens_compared"] += k
                if control:
                    cl = got["control"][j, :k].clone()
                    cl[:, suppress] = float("-inf")
                    out["control_gap"] = max(out["control_gap"], float(
                        _gaps(lg, cl.argmax(dim=-1), suppress).max()))
            del got
    del refs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
