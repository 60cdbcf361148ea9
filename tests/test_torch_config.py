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


@pytest.mark.parametrize("cls", ["WhisperArch", "DecodeConfig"])
def test_dataclass_fields_and_defaults(cls):
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(getattr(jc, cls))]
    tf = [(f.name, f.default, f.type) for f in dataclasses.fields(getattr(tc, cls))]
    assert tf == jf


@pytest.mark.parametrize("name", ["SAMPLE_RATE", "N_FFT", "HOP_LENGTH",
                                  "CHUNK_SECONDS", "N_SAMPLES", "N_FRAMES"])
def test_audio_constants(name):
    assert getattr(tc, name) == getattr(jc, name)
