"""The plain reference (`benchmark/reference/`) against the port on the
port's 2-layer test model, on the CPU, in float32.

The reference imports nothing of the port; this test does, to hold the two
side by side: the frozen quantization rule bit for bit, then the log-mel,
the encoder, the teacher-forced logits, and the greedy tokens through the
port's transcription function.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

from benchlib import tiny, traffic, weights  # noqa: E402
from reference.quant_rule import fake_quant, is_quantized  # noqa: E402
from reference.whisper_ref import WhisperReference  # noqa: E402

CPU = torch.device("cpu")
MODEL = tiny.CONFIG["model"]
WINDOW = MODEL["max_source_positions"] * 320


@pytest.fixture(scope="module")
def setup():
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    tree = weights.make(MODEL, 17, CPU, dtype=torch.float32)
    arch = ARCHS["test2l"]
    params = quantize_params(tree, "int8")
    ref = WhisperReference(MODEL, tree, 8, "none")
    mix = dict(tiny.MIXES["tiny-batch"], batch=3, pool_batches=1)
    wav = torch.from_numpy(traffic.generate(mix, 17, 1.0, WINDOW)["batches"][0])
    return tree, arch, params, ref, wav


def test_quant_rule_is_the_ports(setup):
    from openai_whisper_compression_tpu_torch.models.params import named_leaves
    from openai_whisper_compression_tpu_torch.ops.qtensor import dequantize

    tree, _, params, _, _ = setup
    n = 0
    for name, leaf in named_leaves(params):
        if is_quantized(name):
            w = dict(named_leaves(tree))[name]
            assert torch.equal(dequantize(leaf, torch.float32), fake_quant(w, 8)), name
            n += 1
    assert n == 2 * 6 + 2 * 10    # encoder q k v o fc1 fc2, decoder + cross q k v o


def test_log_mel(setup):
    from openai_whisper_compression_tpu_torch.audio import features

    _, arch, _, ref, wav = setup
    got = features.preprocess(wav, n_mels=arch.num_mel_bins, length=WINDOW)
    want = ref.log_mel(wav)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_encoder(setup):
    from openai_whisper_compression_tpu_torch.models.whisper import encode

    _, arch, params, ref, wav = setup
    mel = ref.log_mel(wav)
    torch.testing.assert_close(encode(params, arch, mel), ref.encode(mel), rtol=1e-4, atol=1e-4)


def test_teacher_forced_logits(setup):
    from openai_whisper_compression_tpu_torch.models.whisper import forward

    _, arch, params, ref, wav = setup
    mel = ref.log_mel(wav)
    tokens = torch.tensor([[998, 999, 5, 17, 300, 2], [998, 999, 40, 41, 42, 43],
                           [998, 999, 996, 0, 1, 7]])
    want = ref.logits(ref.encode(mel), tokens)
    torch.testing.assert_close(forward(params, arch, mel, tokens), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_tokens_are_the_references_best(setup, kv_int8):
    """The port's greedy tokens (suppressed EOT) are the reference's argmax
    at every position; with int8 caches within a small gap of it."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn

    _, arch, params, ref, wav = setup
    cfg = DecodeConfig(max_new_tokens=12, kv_int8=kv_int8, cross_kv_int8=kv_int8,
                       suppress_tokens=(997,))
    tokens, lengths = make_transcribe_fn(arch, cfg, device="cpu")(params, wav)[:2]
    prefix = MODEL["forced_prefix"]
    assert tokens[:, : len(prefix)].tolist() == [prefix] * 3
    assert lengths.tolist() == [len(prefix) + 12] * 3
    tokens = tokens[:, : len(prefix) + 12]
    lg = ref.logits(ref.encode(ref.log_mel(wav)), tokens[:, :-1])[:, len(prefix) - 1:]
    lg[..., 997] = float("-inf")
    served = tokens[:, len(prefix):]
    gap = lg.amax(-1) - lg.gather(-1, served[..., None])[..., 0]
    assert float(gap.max()) <= (0.05 if kv_int8 else 1e-4)
    if not kv_int8:
        assert torch.equal(lg.argmax(-1), served)


def test_int4_control_departs(setup):
    tree, _, _, ref, wav = setup
    ctl = WhisperReference(MODEL, tree, 4, "none")
    mel = ref.log_mel(wav)
    toks = torch.tensor([MODEL["forced_prefix"] + [1, 2, 3]] * 3)
    a, b = ref.logits(ref.encode(mel), toks), ctl.logits(ctl.encode(mel), toks)
    assert float((a - b).abs().max()) > 1e-2


def test_reference_imports_nothing_of_the_program():
    import ast

    for name in os.listdir(os.path.join(BENCH, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(BENCH, "reference", name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                        else [])
                for mod in mods:
                    assert mod.split(".")[0] in {"torch", "numpy", "math", "contextlib",
                                                 "re", "__future__"}, (name, mod)


def test_window_padding(setup):
    *_, ref, wav = setup
    short = wav[:, : WINDOW // 3]
    torch.testing.assert_close(ref.log_mel(short), ref.log_mel(
        torch.nn.functional.pad(short, (0, WINDOW - short.shape[1]))))
    assert np.isfinite(ref.log_mel(short).numpy()).all()


def test_draw_gains_scale_their_leaves_alone():
    from openai_whisper_compression_tpu_torch.models.params import named_leaves

    plain = dict(named_leaves(weights.make(MODEL, 5, CPU, dtype=torch.float32)))
    drawn = dict(named_leaves(weights.make(
        MODEL, 5, CPU, dtype=torch.float32,
        draw={"conv_stem_gain": 4.0, "cross_query_gain": 3.0})))
    scaled = set()
    for name, w in plain.items():
        if name in ("encoder.conv1.w", "encoder.conv2.w"):
            torch.testing.assert_close(drawn[name], 4.0 * w)
            scaled.add(name)
        elif name.startswith("decoder.layers.") and name.endswith(".cross.q.w"):
            torch.testing.assert_close(drawn[name], 3.0 * w)
            scaled.add(name)
        else:
            assert torch.equal(drawn[name], w), name
    assert len(scaled) == 2 + MODEL["decoder_layers"]
    with pytest.raises(ValueError):
        weights.make(MODEL, 5, CPU, dtype=torch.float32, draw={"embed_gain": 2.0})
