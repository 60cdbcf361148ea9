"""Faults planted under the timed path, for showing that the check catches
them (`tests/test_benchmark_faults.py`). `plant` patches the port in this
process and puts it back on exit:

- `token`: a token altered where it is produced: the decode's output has the
  token at the middle generated position replaced by the next id;
- `half_batch`: half of the batch left out: the encoder states of the
  second half of the rows that hold audio are dropped and the first half's
  stand in for them (a bucket's padding rows do not count);
- `state`: a step that leaves its state unchanged: every decode step's
  self-attention works on a copy of the cache, so the cache keeps only the
  prefill;
- `control`: the int4 control in the program's place: the transcription
  function is the plain reference with its linear weights rounded to int4,
  decoding greedily (on the CPU at test sizes only: it recomputes every
  position each step).

The exchange between chips cannot be left out: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("token", "half_batch", "state", "control")


@contextlib.contextmanager
def _patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _token(orig):
    def greedy_decode(params, arch, enc, cfg, *a, **k):
        out = orig(params, arch, enc, cfg, *a, **k)
        tokens = out[0].clone()
        from openai_whisper_compression_tpu_torch.models.decode import forced_prefix

        pos = len(forced_prefix(arch, cfg)) + cfg.max_new_tokens // 2
        tokens[:, pos] = (tokens[:, pos] + 1) % arch.vocab_size
        return (tokens,) + tuple(out[1:])
    return greedy_decode


def _half_batch(orig):
    def encode(params, arch, mel, *a, **k):
        enc = orig(params, arch, mel, *a, **k).clone()
        # the rows that hold audio (a padding row's log-mel is constant)
        live = torch.nonzero(mel.flatten(1).float().std(dim=1) > 0)[:, 0]
        h = (len(live) + 1) // 2
        enc[live[h:]] = enc[live[: len(live) - h]]
        return enc
    return encode


def _unchanged_state(orig):
    def update(q, k_new, v_new, k_cache, v_cache, *rest, **kw):
        rest = tuple(r.clone() if isinstance(r, torch.Tensor) else r for r in rest)
        return orig(q, k_new, v_new, k_cache.clone(), v_cache.clone(), *rest, **kw)
    return update


def _control(config: dict, seed: int):
    from benchlib import weights
    from reference.whisper_ref import WhisperReference

    def make(orig):
        def transcribe_fn(config_, arch, cfg, device):
            m = config["model"]
            ref = WhisperReference(m, weights.of_config(config, seed, device), 4,
                                   config["program"]["encoder_mlp_gelu"])
            prefix = list(m["forced_prefix"])

            @torch.no_grad()
            def fn(params, wav):
                wav = torch.as_tensor(wav, device=device, dtype=torch.float32)
                enc = ref.encode(ref.log_mel(wav))
                toks = torch.tensor([prefix] * wav.shape[0], device=device)
                for _ in range(cfg.max_new_tokens):
                    lg = ref.logits(enc, toks)[:, -1]
                    lg[:, list(cfg.suppress_tokens)] = float("-inf")
                    toks = torch.cat([toks, lg.argmax(-1, keepdim=True)], dim=1)
                return toks, torch.full((wav.shape[0],), toks.shape[1], device=device)
            return fn
        return transcribe_fn
    return make


@contextlib.contextmanager
def plant(name: str, config: dict | None = None, seed: int = 0):
    """Plant fault `name` (one of FAULTS) for the duration of the block."""
    from openai_whisper_compression_tpu_torch.evaluation import harness
    from openai_whisper_compression_tpu_torch.models import decode

    from benchlib import program

    with contextlib.ExitStack() as stack:
        if name == "token":
            stack.enter_context(_patched(harness, "greedy_decode", _token))
        elif name == "half_batch":
            stack.enter_context(_patched(harness, "encode", _half_batch))
        elif name == "state":
            for attr in ("decode_self_attention_update", "decode_self_attention_update_int8"):
                stack.enter_context(_patched(decode, attr, _unchanged_state))
        elif name == "control":
            stack.enter_context(_patched(program, "transcribe_fn", _control(config, seed)))
        else:
            raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
        yield
