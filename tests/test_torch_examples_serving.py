"""The port's examples (`examples_torch/`) against the JAX package's
(`examples/`), part 2: `serving_and_speculative`.

The JAX example runs in a subprocess (`PYTHONPATH` = the repository,
`JAX_PLATFORMS=cpu`) at its defaults, with its temperature ladder's rungs
recorded; the port's `main(["--device", "cpu"])` runs here at the same
defaults on the same weights (`torch_example_runs.same_weights`). Sampled
rungs (temperature > 0) draw from JAX's and torch's generators, which give
different numbers from one seed, so the port's sampled rungs are handed
JAX's recorded draws (tokens, lengths, mean logprobs); its greedy rung runs
as written and must equal JAX's."""

import ast
import json

import numpy as np
import pytest
import torch

from torch_example_runs import assert_lines_match, run_jax_example, same_weights

# records every rung of JAX's `decode_with_fallback` (the jitted decode of
# `_ladder_fns`) into the JSON file named by OWC_RUNGS
RECORD_RUNGS = """
import json, os
import numpy as np
from openai_whisper_compression_tpu.models import fallback as _fb
_real, _rungs = _fb._ladder_fns, {}
def _recording(arch, cfg):
    fn, nsp = _real(arch, cfg)
    def rung(p, e, k, t):
        out = fn(p, e, k, t)
        _rungs[repr(round(float(t), 6))] = [np.asarray(a).tolist() for a in out]
        with open(os.environ["OWC_RUNGS"], "w") as f:
            json.dump(_rungs, f)
        return out
    return rung, nsp
_fb._ladder_fns = _recording
"""

# fields of the service's stats set by the clock or by when its worker
# thread wakes (how the three requests fall into batches), not by the model
STATS_EXEMPT = ("busy_seconds", "rtfx", "latency_p50_ms", "latency_p95_ms",
                "latency_max_ms", "queue_peak", "batches", "mean_batch_occupancy")


@pytest.fixture(autouse=True)
def _jax_weights(monkeypatch):
    same_weights(monkeypatch)


def _stats(out: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith("  stats: "))
    return {k: v for k, v in ast.literal_eval(line[len("  stats: "):]).items()
            if k not in STATS_EXEMPT}


def test_serving_and_speculative_matches_jax(capsys, monkeypatch, tmp_path):
    """Every request's audio seconds and token count, the service's counts,
    speculative == greedy, the word timestamps and the fallback's row
    (temperature, mean logprob, compression ratio, silence) equal to JAX's
    as printed; the latencies and STATS_EXEMPT are exempt. The greedy rung's
    tokens equal JAX's and its mean logprobs lie within 1e-5 (f32 logits
    summed in another order)."""
    from examples_torch import serving_and_speculative
    from openai_whisper_compression_tpu_torch.models import fallback

    rungs_file = tmp_path / "rungs.json"
    want = run_jax_example("serving_and_speculative", prelude=RECORD_RUNGS,
                           env={"OWC_RUNGS": str(rungs_file)})
    rungs = json.loads(rungs_file.read_text())
    assert "0.0" in rungs and len(rungs) > 1   # the ladder went past greedy
    real, greedy_rung = fallback.greedy_decode, {}

    def rung(params, arch, enc, cfg, generator=None, temperature=0.0,
             return_logprobs=False):
        t = repr(round(float(temperature), 6))
        if t == "0.0":
            out = real(params, arch, enc, cfg, generator=generator,
                       temperature=temperature, return_logprobs=return_logprobs)
            greedy_rung["out"] = [x.cpu().numpy() for x in out]
            return out
        toks, lens, lps = rungs[t]
        return (torch.tensor(toks), torch.tensor(lens),
                torch.tensor(lps, dtype=torch.float32))

    monkeypatch.setattr(fallback, "greedy_decode", rung)
    got = serving_and_speculative.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert_lines_match(want, out, exempt=[r"^  stats: "],
                       subs=[(r"latency \d+ ms", "latency <ms>")])
    assert _stats(out) == _stats(want)
    toks, lens, lps = greedy_rung["out"]
    np.testing.assert_array_equal(toks, np.asarray(rungs["0.0"][0]))
    np.testing.assert_array_equal(lens, np.asarray(rungs["0.0"][1]))
    np.testing.assert_allclose(lps, np.asarray(rungs["0.0"][2]), rtol=0, atol=1e-5)
    assert got["speculative_exact"] and len(got["requests"]) == 3
