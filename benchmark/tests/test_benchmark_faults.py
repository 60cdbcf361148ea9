"""The check decides `correct`: sound runs pass it, and the control and each
fault the cells can have fail it.

On the CPU at the size of the port's 2-layer test model (`benchlib/tiny.py`),
through the whole of a run but the look for a card: the window drives the
port's real entry (the transcription function, or the service's worker
thread), and the fault is planted underneath it (`benchlib/faults.py`). The
tiny cells' limit, 0.015, lies between the readings of sound runs on the
CPU (at most 0.0054 over 10-12 seeds a cell) and the smallest of the
control's and the faults' (0.0280). The exchange between chips cannot be
left out: every cell runs on one chip.
"""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

from benchlib import faults, runner, tiny  # noqa: E402
from benchlib.manifest import Bench  # noqa: E402

SEEDS = (101, 102, 2 ** 31 + 7)
CELLS = ("tiny.batch", "tiny.serve")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Bench(tiny.make_bench(str(tmp_path_factory.mktemp("tiny"))))


def _run(bench, cell, seed, control=False):
    return runner.run_cell(bench, cell, seed, 8.0, False, torch.device("cpu"),
                           time.perf_counter(), control=control, log=lambda m: None)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass(bench, cell, seed):
    r = _run(bench, cell, seed, control=True)
    assert r["correct"], r["checks"]
    gap, limit = r["checks"]["logit_gap"]["value"], r["checks"]["logit_gap"]["limit"]
    assert gap < limit < r["control_gap"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail(bench, cell, seed, fault):
    with faults.plant(fault, bench.cell(cell).config, seed):
        r = _run(bench, cell, seed)
    assert not r["correct"], (fault, r["checks"])
    assert r["checks"]["logit_gap"]["value"] > r["checks"]["logit_gap"]["limit"]


def test_faults_are_taken_out_again(bench):
    from openai_whisper_compression_tpu_torch.evaluation import harness
    from openai_whisper_compression_tpu_torch.models import decode

    before = (harness.encode, harness.greedy_decode, decode.decode_self_attention_update_int8)
    for f in faults.FAULTS:
        with faults.plant(f, bench.cell("tiny.batch").config, 1):
            pass
    assert before == (harness.encode, harness.greedy_decode,
                      decode.decode_self_attention_update_int8)
    with pytest.raises(ValueError):
        with faults.plant("no-such-fault"):
            pass


def test_a_missing_answer_is_not_correct(bench, monkeypatch):
    """A request the service never answers counts as failed."""
    from openai_whisper_compression_tpu_torch import serving

    real = serving.TranscriptionService._finalize
    seen = []

    def drop_first(self, entry):
        if not seen:
            seen.append(1)
            return None             # the first batch is never answered
        return real(self, entry)

    monkeypatch.setattr(serving.TranscriptionService, "_finalize", drop_first)
    monkeypatch.setattr(bench.module("entries", "service"), "DRAIN_S", 2.0, raising=True)
    r = _run(bench, "tiny.serve", 5)
    assert not r["correct"] and r["failed"] > 0
