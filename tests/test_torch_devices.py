"""The port's entry points run on the card unless the caller names another
device: `make_transcribe_fn`, `make_speculative_transcribe_fn`,
`init_params`, `from_numpy`, `init_cache` and the long-form functions
(`transcribe_long`, `transcribe_seek`, `transcribe_seek_batch`) default to
"cuda", and so do the serving workloads (`make_cb_fns`,
`ContinuousBatcher`, `StreamingTranscriber`, `StreamingPool`,
`TranscriptionService`), and so do the package API (`load_model`,
`transcribe`) and `Preset.build`; where torch sees no card a call that
names no device raises instead of quietly returning CPU tensors."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu_torch import load_model, serving, streaming, transcribe
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.continuous import ContinuousBatcher
from openai_whisper_compression_tpu_torch.evaluation import longform
from openai_whisper_compression_tpu_torch.evaluation.harness import (
    make_speculative_transcribe_fn, make_transcribe_fn)
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models.cache import init_cache
from openai_whisper_compression_tpu_torch.models.continuous import make_cb_fns
from openai_whisper_compression_tpu_torch.models.params import (
    from_numpy, init_params, resolve_device)
from openai_whisper_compression_tpu_torch.sweep.presets import PRESETS

DEV = "cpu"
ARCH = ARCHS["test2l"]

TS_ARCH = ARCHS["test2l-ts"]    # test2l's shapes, with timestamp tokens
# the entry points that hand back tensors, and the long-form ones (dicts)
ENTRY_POINTS = {"make_transcribe_fn": make_transcribe_fn, "init_params": init_params,
                "from_numpy": from_numpy, "init_cache": init_cache,
                "make_speculative_transcribe_fn": make_speculative_transcribe_fn,
                "load_model": load_model, "Preset.build": PRESETS["small_int8"].build}
LONGFORM = {"transcribe": transcribe, "transcribe_long": longform.transcribe_long,
            "transcribe_seek": longform.transcribe_seek,
            "transcribe_seek_batch": longform.transcribe_seek_batch}
# the serving workloads: constructors and a builder
SERVING = {"make_cb_fns": make_cb_fns, "ContinuousBatcher": ContinuousBatcher,
           "StreamingTranscriber": streaming.StreamingTranscriber,
           "StreamingPool": streaming.StreamingPool,
           "TranscriptionService": serving.TranscriptionService}


def _calls(params):
    """Each entry point called as a user would, with extra keywords."""
    cfg, tok = DecodeConfig(max_new_tokens=2, notimestamps=False), WordTokenizer(1000, 897)
    wav = np.zeros(1000, np.float32)
    return {
        "make_transcribe_fn": lambda **kw: make_transcribe_fn(
            ARCH, DecodeConfig(max_new_tokens=2), **kw),
        "init_params": lambda **kw: init_params(ARCH, 0, **kw),
        "from_numpy": lambda **kw: from_numpy({"w": np.ones((2, 3), np.float32)}, **kw),
        "init_cache": lambda **kw: init_cache(params, ARCH, 2, 8, **kw),
        "make_speculative_transcribe_fn": lambda **kw: make_speculative_transcribe_fn(
            ARCH, ARCH, DecodeConfig(max_new_tokens=2), gamma=2, **kw),
        "load_model": lambda **kw: load_model("test2l", **kw),
        "Preset.build": lambda **kw: PRESETS["small_int8"].build(arch_override="test2l", **kw),
        "transcribe": lambda **kw: transcribe(
            params, ARCH, wav, tok, DecodeConfig(max_new_tokens=2), batch_size=1, **kw),
        "transcribe_long": lambda **kw: longform.transcribe_long(
            params, ARCH, wav, tok, DecodeConfig(max_new_tokens=2), batch_size=1, **kw),
        "transcribe_seek": lambda **kw: longform.transcribe_seek(
            params, TS_ARCH, wav, tok, cfg, **kw),
        "transcribe_seek_batch": lambda **kw: longform.transcribe_seek_batch(
            params, TS_ARCH, [wav], tok, cfg, batch_size=1, **kw),
        "make_cb_fns": lambda **kw: make_cb_fns(ARCH, DecodeConfig(max_new_tokens=2), 2,
                                                chunk=2, **kw),
        "ContinuousBatcher": lambda **kw: ContinuousBatcher(
            params, ARCH, DecodeConfig(max_new_tokens=2), batch=2, chunk=2, **kw),
        "StreamingTranscriber": lambda **kw: streaming.StreamingTranscriber(
            params, TS_ARCH, tok, cfg, **kw),
        "StreamingPool": lambda **kw: streaming.StreamingPool(
            params, TS_ARCH, tok, cfg, max_streams=2, **kw),
        "TranscriptionService": lambda **kw: serving.TranscriptionService(
            params, ARCH, tok, DecodeConfig(max_new_tokens=2), batch_size=2, **kw),
    }


@pytest.fixture(scope="module")
def params():
    return init_params(ARCH, 0, device=DEV)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS) + sorted(LONGFORM) + sorted(SERVING))
def test_entry_point_defaults_to_the_card(name):
    fn = {**ENTRY_POINTS, **LONGFORM, **SERVING}[name]
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default).type == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS) + sorted(LONGFORM) + sorted(SERVING))
def test_no_card_and_no_device_raises(name, params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _calls(params)[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_named_cpu_device_gives_cpu_tensors(name, params):
    out = _calls(params)[name](device=DEV)
    if name == "make_transcribe_fn":
        out = out(params, np.zeros((1, 480_000), np.float32))
    if name == "make_speculative_transcribe_fn":
        out = out(params, params, np.zeros((1, 480_000), np.float32))
    leaves = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(out)
    assert leaves and all(t.device.type == "cpu" for t in leaves)


@pytest.mark.parametrize("name", sorted(LONGFORM))
def test_longform_on_a_named_cpu_device(name, params):
    out = _calls(params)[name](device=DEV)
    for res in (out if isinstance(out, list) else [out]):
        assert isinstance(res["text"], str) and res["audio_seconds"] == 1000 / 16000.0


def test_resolve_device_passes_a_cpu_device_through(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))


@pytest.mark.parametrize("name", sorted(SERVING))
def test_serving_workloads_on_a_named_cpu_device(name, params):
    """Each serving entry point runs on a named CPU device: its state, its
    mirror or its results on the CPU."""
    out = _calls(params)[name](device=DEV)
    wav = np.zeros(4000, np.float32)
    if name == "make_cb_fns":
        _, fns = out
        state = fns["init"](params)
        assert all(t.device.type == "cpu" for t in
                   (state["tokens"], state["start"], state["cross"][0].k_t))
    elif name == "ContinuousBatcher":
        (tokens,) = out.transcribe_all([wav])
        assert isinstance(tokens, np.ndarray) and len(tokens) >= 1
    elif name == "StreamingTranscriber":
        assert isinstance(out.flush()["committed"], str)
    elif name == "StreamingPool":
        assert out._mirror.device.type == "cpu"
        out.open("a")
        out.feed("a", wav)
        assert isinstance(out.close("a")["committed"], str)
    else:
        try:
            res = out.transcribe(wav, timeout=300)
        finally:
            out.close(timeout=300)
        assert not out._worker.is_alive() and isinstance(res["text"], str)
