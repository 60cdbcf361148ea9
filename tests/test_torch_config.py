"""The port's config.py against the JAX package's, field for field."""

import dataclasses

import pytest
import torch

from openai_whisper_compression_tpu import config as jc
from openai_whisper_compression_tpu_torch import config as tc

torch.set_num_threads(2)

_PROPS = ("head_dim", "task_transcribe_token_id", "task_translate_token_id",
          "no_speech_token_id", "language_en_token_id")


def test_same_arch_names():
    assert list(tc.ARCHS) == list(jc.ARCHS)


@pytest.mark.parametrize("name", list(jc.ARCHS))
def test_arch_fields_and_properties(name):
    j, t = jc.ARCHS[name], tc.ARCHS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in _PROPS:
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("cls", ["WhisperArch", "DecodeConfig", "EvalConfig",
                                 "RunConfig"])
def test_dataclass_fields_and_defaults(cls):
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(getattr(jc, cls))]
    tf = [(f.name, f.default, f.type) for f in dataclasses.fields(getattr(tc, cls))]
    assert tf == jf


@pytest.mark.parametrize("name", ["SAMPLE_RATE", "N_FFT", "HOP_LENGTH",
                                  "CHUNK_SECONDS", "N_SAMPLES", "N_FRAMES"])
def test_audio_constants(name):
    assert getattr(tc, name) == getattr(jc, name)


def test_run_config_json_matches_jax():
    """`RunConfig.to_json` gives the JAX package's text for the same fields,
    and `from_json` reads it back."""
    kw = dict(model="small", dtype="bfloat16", quantization={"method": "int8"},
              recovery={"qat": True, "steps": 10})
    dec = dict(max_new_tokens=25, kv_int8=True, suppress_tokens=(5, 7))
    ev = dict(batch_size=96, normalizer="whisper")
    t = tc.RunConfig(**kw, decode=tc.DecodeConfig(**dec), eval=tc.EvalConfig(**ev))
    j = jc.RunConfig(**kw, decode=jc.DecodeConfig(**dec), eval=jc.EvalConfig(**ev))
    assert t.to_json() == j.to_json()
    assert tc.RunConfig().to_json() == jc.RunConfig().to_json()
    back = tc.RunConfig.from_json(t.to_json())
    assert back.eval == t.eval and back.decode.kv_int8 and back.model == "small"


@pytest.mark.parametrize("name", ["small", "large-v3", "tiny.en"])
def test_language_tokens_match_jax(name):
    assert tc.LANGUAGES == jc.LANGUAGES
    ta, ja = tc.ARCHS[name], jc.ARCHS[name]
    for code in ("en", "de", "yue", "haw", 12, "xx"):
        try:
            want = jc.language_token_id(ja, code)
        except ValueError:
            with pytest.raises(ValueError):
                tc.language_token_id(ta, code)
            continue
        assert tc.language_token_id(ta, code) == want
        if isinstance(code, str):
            assert tc.language_code(ta, want) == jc.language_code(ja, want) == code
    with pytest.raises(ValueError):
        tc.language_code(ta, ta.decoder_start_token_id)
