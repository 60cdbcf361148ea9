"""The port's per-sample evaluation stack (`evaluation/profiler.py`), its
EDA (`evaluation/eda.py`) and `utils/{profiling,paths,logging_setup}.py`
against the JAX package's on test2l (the same weights, carried over by
`from_numpy`). Sizes, counts, records' hypotheses and WER/CER, summaries and
dataset statistics are equal; the exported WAV is byte-equal; FLOPs of a
matmul are the exact 2·M·N·K, which XLA's cost model also reports."""

import csv
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation import eda as jax_eda
from openai_whisper_compression_tpu.evaluation import profiler as jax_prof
from openai_whisper_compression_tpu.evaluation.data import synthetic_dataset as jax_synth
from openai_whisper_compression_tpu.evaluation.tokenizer import WordTokenizer as JaxTok
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.utils import profiling as jax_profiling
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation import eda, profiler
from openai_whisper_compression_tpu_torch.evaluation.data import synthetic_dataset
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models.params import from_numpy
from openai_whisper_compression_tpu_torch.utils import logging_setup, paths, profiling

DEV = "cpu"
J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
CFG = dict(max_new_tokens=6, language_token_id=None, task_token_id=None,
           notimestamps=False)


@pytest.fixture(scope="module")
def trees():
    jp = JP.init_params(J_ARCH, jax.random.PRNGKey(0))
    jq = jax_api.quantize_params(jp, "int8")
    port = lambda t: from_numpy(jax.tree.map(np.asarray, t), device=DEV)  # noqa: E731
    return {"dense": (jp, port(jp)), "int8": (jq, port(jq))}


def test_setup_device_and_format_time(capsys):
    assert profiler.setup_device("cpu") == torch.device("cpu")
    assert "CPU" in capsys.readouterr().out
    with pytest.raises(RuntimeError):
        profiler.setup_device()          # the card by default; none here
    for s in (12.3, 90, 7200, 0.004, 3599.9):
        assert profiler.format_time(s) == jax_prof.format_time(s)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_model_profiler_sizes_match_jax(trees, kind):
    jt, pt = trees[kind]
    got = profiler.ModelProfiler("p").get_detailed_model_size(pt)
    want = jax_prof.ModelProfiler("j").get_detailed_model_size(jt)
    assert got["total_params"] == want["total_params"]
    assert got["total_size_mb"] == pytest.approx(want["total_size_mb"], rel=1e-12)
    assert profiler.ModelProfiler.measure_model_size(pt) == pytest.approx(
        jax_prof.ModelProfiler.measure_model_size(jt), rel=1e-12)
    assert got["layer_info"] == want["layer_info"]
    profiler.ModelProfiler("p").print_size_analysis()      # nothing to print: no raise


def test_error_metrics_match_jax():
    for ref, hyp in [("Hello, World!", "hello world"), ("a b c d", "a b x d"),
                     ("", "x"), ("the cat", "")]:
        assert profiler.ModelProfiler.calculate_error_metrics(ref, hyp) == \
            jax_prof.ModelProfiler.calculate_error_metrics(ref, hyp)


def test_evaluator_matches_jax(trees, tmp_path):
    jt, pt = trees["dense"]
    data = synthetic_dataset(3, seed=2, vocab_size=500, min_dur=1.0, max_dur=2.0)
    jdata = jax_synth(3, seed=2, vocab_size=500, min_dur=1.0, max_dur=2.0)
    prof = profiler.ModelProfiler("test2l", results_dir=str(tmp_path))
    ev = profiler.WhisperEvaluator(pt, ARCH, WordTokenizer(ARCH.vocab_size, special_start=997),
                                   prof, DecodeConfig(**CFG), device=DEV)
    got = ev.evaluate_dataset(data)
    want = jax_prof.WhisperEvaluator(
        jt, J_ARCH, JaxTok(J_ARCH.vocab_size, special_start=997),
        jax_prof.ModelProfiler("j"), JaxDecodeConfig(**CFG)).evaluate_dataset(jdata)
    for g, w in zip(got, want):
        for k in ("reference", "hypothesis", "wer", "cer", "sample_id"):
            assert g[k] == w[k], k
        assert g["inference_time"] > 0 and isinstance(g["memory_used"], float)
    assert len(prof.metrics_history) == 3
    with open(prof.save_metrics("metrics.csv")) as f:
        assert len(list(csv.DictReader(f))) == 3
    for r in want:
        r["inference_time"], r["memory_used"] = 1.0, 2.0
    for r in got:
        r["inference_time"], r["memory_used"] = 1.0, 2.0
    assert profiler.TranscriptionMetrics.calculate_summary_metrics(got, 1.5) == \
        jax_prof.TranscriptionMetrics.calculate_summary_metrics(want, 1.5)
    s = profiler.TranscriptionMetrics.calculate_summary_metrics(got)
    assert os.path.exists(profiler.TranscriptionMetrics.save_summary(
        s, str(tmp_path / "summary.csv")))
    profiler.TranscriptionMetrics.print_summary(s)
    profiler.TranscriptionMetrics.print_sample_comparisons(got, 2)
    for p in (profiler.VisualizationUtils.plot_error_distributions(got, str(tmp_path / "e.png")),
              profiler.VisualizationUtils.plot_performance_metrics(got, str(tmp_path / "p.png"))):
        assert os.path.getsize(p) > 0
    assert os.path.exists(ev.save_model(str(tmp_path / "model")))


def test_eda_matches_jax(tmp_path):
    data = synthetic_dataset(6, seed=0, min_dur=1.0, max_dur=3.0)
    jdata = jax_synth(6, seed=0, min_dur=1.0, max_dur=3.0)
    assert eda.examine_dataset(data) == jax_eda.examine_dataset(jdata)
    paths_ = eda.plot_dataset_distributions(data, str(tmp_path / "p"))
    paths_ += eda.plot_sample(data[0], str(tmp_path / "p"))
    assert [os.path.basename(p) for p in paths_] == [os.path.basename(p) for p in (
        jax_eda.plot_dataset_distributions(jdata, str(tmp_path / "j"))
        + jax_eda.plot_sample(jdata[0], str(tmp_path / "j")))]
    assert all(os.path.getsize(p) > 0 for p in paths_)
    got = eda.export_sample(data[0], str(tmp_path / "p"))
    want = jax_eda.export_sample(jdata[0], str(tmp_path / "j"))
    assert open(got, "rb").read() == open(want, "rb").read()
    with wave.open(got, "rb") as f:
        assert f.getframerate() == 16000 and f.getnframes() == len(data[0].audio)


def test_cost_analysis_counts_matmul_flops_and_bytes():
    x = torch.ones(128, 128)
    costs = profiling.cost_analysis(lambda a: (a @ a).sum(), x)
    jcosts = jax_profiling.cost_analysis(lambda a: (a @ a).sum(), jnp.ones((128, 128)))
    assert costs["flops"] == 2 * 128 ** 3
    assert jcosts["flops"] >= costs["flops"]          # XLA adds the sum's adds
    assert costs["bytes accessed"] == 128 * 128 * 4 + 4   # x read, one scalar out
    assert set(costs) == {"flops", "bytes accessed"}   # no kernel: no transcendentals
    assert all(v > 0 for v in costs.values())


def test_timed_and_flops_per_second():
    x = torch.ones(64, 64)
    t = profiling.timed(lambda a: a @ a, x, iters=3)
    assert t["iters"] == 3 and 0 < t["min_s"] <= t["median_s"] <= t["max_s"]
    perf = profiling.flops_per_second(lambda a: a @ a, x, iters=2)
    assert perf["model_flops"] == 2 * 64 ** 3 and perf["achieved_tflops"] > 0
    none = profiling.flops_per_second(lambda a: a + 1, x, iters=2)
    assert none["model_flops"] == 0 and none["achieved_tflops"] is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0


def test_paths_and_logging_match_jax(tmp_path):
    from openai_whisper_compression_tpu.utils import paths as jax_paths

    p = paths.ProjectPaths(str(tmp_path / "p"), run_name="r1")
    j = jax_paths.ProjectPaths(str(tmp_path / "j"), run_name="r1")
    for attr in ("results_dir", "models_dir", "plots_dir"):
        assert os.path.relpath(getattr(p, attr), tmp_path / "p") == \
            os.path.relpath(getattr(j, attr), tmp_path / "j")
    assert p.result_file("x.json").endswith("results/r1/x.json")
    assert paths.ProjectPaths(str(tmp_path)).run_name
    log = logging_setup.setup_logging(log_file=None)
    assert log.name == "whisper_eval" and logging_setup.setup_logging() is log
