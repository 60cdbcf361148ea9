"""The port's compression -> speed curve (`sweep/curve.py`) against the
JAX package on `test2l`, the same weights on both sides (`init_params_jit`,
carried over by `from_numpy`).

`run_curve` on a subset with recovery and on the token-merge rungs: every
field but rtfx equal to JAX's (sizes, HBM, parameters, token and top-1
agreement; mean KL and the logits' relative error, rounded to 4 places by
both, within 1e-4, since f32 sums of another order may move the last
place); and the rung rule against the reference defect at JAX
`curve.py:214`: a failed `+recover` variant there adds a second point for
its rung, the port keeps one and records the failure on it."""

import os

import jax
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.sweep import curve as jax_curve
from openai_whisper_compression_tpu_torch.config import ARCHS
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.sweep import curve

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
KL_ATOL = 1e-4   # mean_kl / logit_rel_err, each rounded to 4 places by both


@pytest.fixture(scope="module")
def setup():
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)


CURVE_KW = dict(batch=2, tokens=6, iters=1, agreement_samples=2, progress=lambda *_: None)


def _assert_points_match(got, want):
    assert [p["name"] for p in got] == [p["name"] for p in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["name"]
        for k in g:
            if k == "rtfx":
                assert g[k] > 0
            elif k == "recovered":
                _assert_points_match([g[k]], [w[k]])
            elif k in ("mean_kl", "logit_rel_err"):
                assert abs(g[k] - w[k]) <= KL_ATOL, (g["name"], k, g[k], w[k])
            else:
                assert g[k] == w[k], (g["name"], k, g[k], w[k])


def test_run_curve_subset_with_recovery_matches_jax(setup):
    jp, tp = setup
    kw = dict(CURVE_KW, recover_steps=1, rungs=["dense", "heads50+int8"])
    points = curve.run_curve(tp, ARCH, **kw)
    assert [p["name"] for p in points] == ["dense", "heads50+int8"]
    assert points[0]["token_agreement"] == 1.0
    assert points[1]["size_mb"] < points[0]["size_mb"]
    assert points[1]["recovered"]["name"] == "heads50+int8+recover"
    assert points[1]["recovered"]["mean_kl"] <= points[1]["mean_kl"] + 1e-6
    _assert_points_match(points, jax_curve.run_curve(jp, J_ARCH, **kw))


def test_run_curve_merge_rungs_match_jax(setup, tmp_path):
    """The decode-time rungs (token merging; pooling after head and FFN
    surgery): no recovery variant, the same points as JAX's; the plot
    draws what it can and skips a failed rung."""
    jp, tp = setup
    kw = dict(CURVE_KW, recover_steps=1, rungs=["tome25%", "ffn50+pool2"])
    points = curve.run_curve(tp, ARCH, **kw)
    assert [p["name"] for p in points] == ["tome25%+int8", "heads50+ffn50+pool2+int8"]
    assert all("recovered" not in p for p in points)
    _assert_points_match(points, jax_curve.run_curve(jp, J_ARCH, **kw))
    pytest.importorskip("matplotlib")
    curve.plot_curve(points + [{"name": "x", "error": "e"}], str(tmp_path / "c.png"))
    assert os.path.getsize(tmp_path / "c.png") > 1000


def test_one_point_per_rung_when_recovery_fails(setup, monkeypatch, tmp_path):
    """A `+recover` variant that fails after its rung measured: the port
    keeps the rung's one point and records the failure on it; JAX's
    `run_curve` adds a second point for the rung (the reference defect at
    its `curve.py:214`, not copied)."""
    jp, tp = setup
    kw = dict(CURVE_KW, recover_steps=1, rungs=["heads50+int8"])

    def failing_second(real):
        calls = []

        def measure(*a, **k):
            calls.append(1)
            if len(calls) == 2:        # the +recover variant's measurement
                raise RuntimeError("out of memory")
            return real(*a, **k)
        return measure

    rng = np.random.default_rng(0)
    pool = (rng.standard_normal((8, ARCH.num_mel_bins, 2 * ARCH.max_source_positions)
                                ).astype(np.float32),
            rng.integers(0, 997, (8, 16)), rng.standard_normal((8, 16, ARCH.vocab_size)
                                                               ).astype(np.float32))
    for mod in (curve, jax_curve):   # any distillation pool will do here
        monkeypatch.setattr(mod, "_recovery_pool", lambda *a, **k: pool)
        monkeypatch.setattr(mod, "_measure_rtfx", failing_second(mod._measure_rtfx))
    points = curve.run_curve(tp, ARCH, **kw)
    assert [p["name"] for p in points] == ["heads50+int8"]
    assert "error" not in points[0] and points[0]["rtfx"] > 0
    assert points[0]["recovered"] == {"name": "heads50+int8+recover",
                                      "error": "RuntimeError('out of memory')"}
    jpoints = jax_curve.run_curve(jp, J_ARCH, **kw)
    assert [p["name"] for p in jpoints] == ["heads50+int8", "heads50+int8"]
    assert "error" in jpoints[1]
    pytest.importorskip("matplotlib")
    curve.plot_curve(points, str(tmp_path / "c.png"))
    assert os.path.getsize(tmp_path / "c.png") > 1000
