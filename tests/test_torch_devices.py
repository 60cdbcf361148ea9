"""The port's entry points run on the card unless the caller names another
device: `make_transcribe_fn`, `init_params`, `from_numpy` and `init_cache`
default to "cuda", and where torch sees no card a call that names no device
raises instead of quietly returning CPU tensors."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models.cache import init_cache
from openai_whisper_compression_tpu_torch.models.params import (
    from_numpy, init_params, resolve_device)

DEV = "cpu"
ARCH = ARCHS["test2l"]

ENTRY_POINTS = {"make_transcribe_fn": make_transcribe_fn, "init_params": init_params,
                "from_numpy": from_numpy, "init_cache": init_cache}


def _calls(params):
    """Each entry point called as a user would, with extra keywords."""
    return {
        "make_transcribe_fn": lambda **kw: make_transcribe_fn(
            ARCH, DecodeConfig(max_new_tokens=2), **kw),
        "init_params": lambda **kw: init_params(ARCH, 0, **kw),
        "from_numpy": lambda **kw: from_numpy({"w": np.ones((2, 3), np.float32)}, **kw),
        "init_cache": lambda **kw: init_cache(params, ARCH, 2, 8, **kw),
    }


@pytest.fixture(scope="module")
def params():
    return init_params(ARCH, 0, device=DEV)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"].default
    assert torch.device(default).type == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_card_and_no_device_raises(name, params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _calls(params)[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_named_cpu_device_gives_cpu_tensors(name, params):
    out = _calls(params)[name](device=DEV)
    if name == "make_transcribe_fn":
        out = out(params, np.zeros((1, 480_000), np.float32))
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


def test_resolve_device_passes_a_cpu_device_through(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))
