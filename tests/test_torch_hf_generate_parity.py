"""The port's decoders against HF `model.generate()` on a tiny random HF
Whisper converted by the port's `models/convert.py::from_hf_state_dict`.

The cases of `tests/test_hf_generate_parity.py` (which holds the JAX
package to the same oracle): one tiny random HF Whisper whose vocab mirrors
the real OpenAI special-token layout, scaled down (text 0..899,
<|eot|>=900, <|sot|>=901, languages 902.., tasks 905/906, <|sop|>=908,
<|notimestamps|>=910, timestamps 911..999), with the EOT output-embedding
row crafted so that sequences finish at audio-dependent lengths. HF
`generate()` runs with its real logits processors; the port's greedy and
beam decoders (f32, on the CPU) must give its tokens exactly: greedy,
translate, suppress and begin-suppress, the length cutoff, timestamps (and
with suppress), the prompt, and beam 5 with three length penalties,
timestamps and suppress. The HF model is converted by the port alone: no
JAX array is involved."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
from transformers import (GenerationConfig, WhisperConfig,  # noqa: E402
                          WhisperForConditionalGeneration)

from openai_whisper_compression_tpu_torch.config import DecodeConfig  # noqa: E402
from openai_whisper_compression_tpu_torch.models import convert, decode  # noqa: E402
from openai_whisper_compression_tpu_torch.models.whisper import encode  # noqa: E402

torch.set_num_threads(2)

V = 1000
EOT, SOT = 900, 901
LANG_EN, LANG_DE = 902, 903
TRANSLATE, TRANSCRIBE = 905, 906
SOP = 908            # <|startofprev|>
NOTS = 910           # timestamps are 911..999
N_TEXT = 900


def _make_pair(seed=11, d=64, heads=4, layers=2, src_pos=32, tgt_pos=64):
    """A tiny HF Whisper with the real special-token layout and a crafted
    EOT row, and its port tree and arch (`from_hf_state_dict`,
    `arch_from_hf_config`)."""
    torch.manual_seed(seed)
    cfg = WhisperConfig(
        vocab_size=V, num_mel_bins=80, d_model=d,
        encoder_layers=layers, encoder_attention_heads=heads,
        decoder_layers=layers, decoder_attention_heads=heads,
        encoder_ffn_dim=4 * d, decoder_ffn_dim=4 * d,
        max_source_positions=src_pos, max_target_positions=tgt_pos,
        pad_token_id=EOT, bos_token_id=EOT, eos_token_id=EOT,
        decoder_start_token_id=SOT,
    )
    model = WhisperForConditionalGeneration(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    model.proj_out.weight = model.model.decoder.embed_tokens.weight
    from transformers.models.whisper.modeling_whisper import sinusoids
    with torch.no_grad():
        model.model.encoder.embed_positions.weight.copy_(sinusoids(src_pos, d))

    # the EOT row (tied with proj_out) from the model's own logit
    # statistics, so that the EOT-vs-dominant-token gap depends on the audio
    g = np.random.default_rng(seed)
    mel = g.standard_normal((8, 80, 2 * src_pos)).astype(np.float32)
    ids = torch.tensor([[SOT, LANG_EN, TRANSCRIBE, NOTS]] * len(mel))
    with torch.no_grad():
        logits = model(input_features=torch.from_numpy(mel),
                       decoder_input_ids=ids).logits[:, -1].numpy()
    text = list(range(N_TEXT))
    A = logits[:, text]
    Z = A - A.mean(axis=0, keepdims=True)
    c = np.linalg.svd(Z, full_matrices=False)[2][0]
    m = A.mean(axis=0)
    c = c - ((A @ c).mean() / (A @ m).mean()) * m
    gamma = 2.0 / max(float((A @ c).std()), 1e-9)
    dom = int(np.bincount(logits.argmax(axis=1)).argmax())
    with torch.no_grad():
        emb = model.model.decoder.embed_tokens.weight
        emb[EOT] = emb[dom] + torch.from_numpy(
            gamma * (c[:, None] * emb.numpy()[text]).sum(axis=0))

    gc = GenerationConfig(decoder_start_token_id=SOT, eos_token_id=EOT,
                          pad_token_id=EOT, bos_token_id=EOT, max_length=tgt_pos)
    gc.no_timestamps_token_id = NOTS
    gc.lang_to_id = {"<|en|>": LANG_EN, "<|de|>": LANG_DE}
    gc.task_to_id = {"transcribe": TRANSCRIBE, "translate": TRANSLATE}
    gc.is_multilingual = True
    gc.prev_sot_token_id = SOP
    gc.max_initial_timestamp_index = 50
    model.generation_config = gc

    params = convert.from_hf_state_dict(model.state_dict())
    arch = convert.arch_from_hf_config(cfg).replace(no_timestamps_token_id=NOTS)
    assert arch.eos_token_id == EOT and arch.decoder_start_token_id == SOT
    assert arch.language_en_token_id == LANG_EN
    assert arch.task_transcribe_token_id == TRANSCRIBE
    assert arch.task_translate_token_id == TRANSLATE
    return model, params, arch


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


@pytest.fixture(scope="module")
def mel(pair):
    _, _, arch = pair
    g = np.random.default_rng(23)
    return g.standard_normal(
        (3, arch.num_mel_bins, 2 * arch.max_source_positions)).astype(np.float32)


def _cut(row):
    """A generated-token list cut at its first EOT (HF sometimes strips the
    EOT, sometimes keeps it; what follows is batch padding)."""
    row = [int(t) for t in row]
    return row[: row.index(EOT)] if EOT in row else row


def _hf(model, mel, **kw):
    """HF generate -> per-row generated-token lists (the prefix stripped)."""
    with torch.no_grad():
        out = model.generate(torch.from_numpy(mel), do_sample=False, **kw)
    return [_cut(r) for r in out.tolist()]


def _run_ours(pair, mel, cfg, **kw):
    _, params, arch = pair
    with torch.inference_mode():
        enc = encode(params, arch, torch.from_numpy(mel))
        fn = decode.beam_decode if cfg.beam_size > 1 else decode.greedy_decode
        tokens, lengths = fn(params, arch, enc, cfg, **kw)
    first_gen = len(decode.forced_prefix(arch, cfg))
    if "prompt_tokens" in kw:
        first_gen += kw["prompt_tokens"].shape[1]
    tokens, lengths = tokens.numpy(), lengths.numpy()
    return [_cut(tokens[b, first_gen: lengths[b]]) for b in range(tokens.shape[0])]


def _base_cfg(**kw):
    kw.setdefault("max_new_tokens", 24)
    kw.setdefault("language_token_id", LANG_EN)
    kw.setdefault("task_token_id", TRANSCRIBE)
    return DecodeConfig(**kw)


# ---------------------------------------------------------------- greedy

def test_converted_tree_is_the_hf_model(pair):
    """`from_hf_state_dict` transposes every linear and keeps the rest: the
    tree's leaves are the HF parameters."""
    model, params, _ = pair
    sd = model.state_dict()
    assert torch.equal(params["decoder"]["embed"], sd["model.decoder.embed_tokens.weight"])
    assert torch.equal(params["encoder"]["layers"][1]["fc2"]["w"],
                       sd["model.encoder.layers.1.fc2.weight"].t())
    assert "b" not in params["decoder"]["layers"][0]["cross"]["k"]


def test_greedy_plain(pair, mel):
    ours = _run_ours(pair, mel, _base_cfg())
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=24)


def test_greedy_translate_prefix(pair, mel):
    ours = _run_ours(pair, mel, _base_cfg(task_token_id=TRANSLATE))
    assert ours == _hf(pair[0], mel, language="en", task="translate", num_beams=1,
                       max_new_tokens=24)


def test_greedy_suppress_tokens(pair, mel):
    base = _run_ours(pair, mel, _base_cfg())
    banned = sorted({t for r in base for t in r[:2]} - {EOT})[:3]
    assert banned, "the fixture produced no text tokens to ban"
    ours = _run_ours(pair, mel, _base_cfg(suppress_tokens=tuple(banned)))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=24, suppress_tokens=banned)
    assert all(not set(banned) & set(row) for row in ours)


def test_greedy_begin_suppress(pair, mel):
    base = _run_ours(pair, mel, _base_cfg())
    banned = sorted({r[0] for r in base if r} - {EOT})
    assert banned, "the fixture produced no first tokens to ban"
    ours = _run_ours(pair, mel, _base_cfg(begin_suppress_tokens=tuple(banned)))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=24, begin_suppress_tokens=banned)
    assert all(not row or row[0] not in banned for row in ours)


def test_greedy_max_length_cutoff(pair, mel):
    ours = _run_ours(pair, mel, _base_cfg(max_new_tokens=6))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=6)
    assert max(len(r) for r in ours) <= 6


def test_greedy_timestamps(pair, mel):
    ours = _run_ours(pair, mel, _base_cfg(notimestamps=False))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=24, return_timestamps=True)
    assert all(not row or row[0] >= NOTS + 1 for row in ours)


def test_greedy_timestamps_suppress(pair, mel):
    base = _run_ours(pair, mel, _base_cfg(notimestamps=False))
    banned = sorted({t for r in base for t in r if t < N_TEXT})[:2]
    assert banned, "the timestamp-mode outputs hold no text tokens to ban"
    ours = _run_ours(pair, mel, _base_cfg(notimestamps=False, suppress_tokens=tuple(banned)))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=24, return_timestamps=True, suppress_tokens=banned)


def test_greedy_prompt_conditioning(pair, mel):
    """HF prompt_ids: [<|sop|>, *prompt] before the forced prefix."""
    prompt = [7, 13, 42]
    pt = torch.tensor([[SOP] + prompt] * mel.shape[0])
    ours = _run_ours(pair, mel, _base_cfg(), prompt_tokens=pt)
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=1,
                       max_new_tokens=24, prompt_ids=torch.tensor([SOP] + prompt))


# ------------------------------------------------------------------ beam

@pytest.mark.parametrize("lp", [1.0, 0.6, 2.0])
def test_beam5_length_penalty(pair, mel, lp):
    ours = _run_ours(pair, mel, _base_cfg(beam_size=5, length_penalty=lp))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=5,
                       max_new_tokens=24, length_penalty=lp)


def test_beam5_timestamps(pair, mel):
    ours = _run_ours(pair, mel, _base_cfg(beam_size=5, notimestamps=False))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=5,
                       max_new_tokens=24, return_timestamps=True)


def test_beam5_suppress(pair, mel):
    base = _run_ours(pair, mel, _base_cfg(beam_size=5))
    banned = sorted({r[0] for r in base if r} - {EOT})
    assert banned, "the fixture produced no first tokens to ban"
    ours = _run_ours(pair, mel, _base_cfg(beam_size=5, suppress_tokens=tuple(banned)))
    assert ours == _hf(pair[0], mel, language="en", task="transcribe", num_beams=5,
                       max_new_tokens=24, suppress_tokens=banned)


def test_fixture_is_ragged(pair, mel):
    """The matrix means something only if sequences finish at ragged,
    audio-dependent lengths."""
    lens = [len(r) for r in _run_ours(pair, mel, _base_cfg())]
    assert len(set(lens)) >= 2, f"the crafted EOT lost raggedness: {lens}"
    assert min(lens) < 24, "no sequence finished before the cutoff"
