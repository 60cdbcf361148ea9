"""The port's `sweep/plots.py` and `sensitivity/plots.py` against the JAX
package's: the same files from the same results (names and count), and
modules that import without matplotlib (the card's machine has none; the
CLI then writes its JSON and says it drew nothing)."""

import os
import subprocess
import sys

import pytest

from openai_whisper_compression_tpu.sensitivity import plots as jax_sens_plots
from openai_whisper_compression_tpu.sweep import plots as jax_plots
from openai_whisper_compression_tpu_torch.sensitivity import plots as sens_plots
from openai_whisper_compression_tpu_torch.sweep import plots


def _results(varying: bool = True):
    res = {f"p{i}": {"model_size_mb": 1.0 + i, "sparsity": (i / 10) if varying else 0.0,
                     "gflops": 1.0,
                     "splits": {"test_clean": {"wer": 0.1 * i, "cer": 0.05 * i, "rtf": 0.01,
                                               "rtfx": 100 - i,
                                               "avg_latency_per_batch_s": 0.1,
                                               "wer_vs_baseline": 0.02 * i},
                                "test_other": {"wer": 0.12 * i, "cer": 0.06 * i,
                                               "rtf": 0.01, "rtfx": 90 - i,
                                               "avg_latency_per_batch_s": 0.1}}}
           for i in range(4)}
    res["boom"] = {"error": "x"}
    return res


def _names(paths):
    return [os.path.basename(p) for p in paths]


@pytest.mark.parametrize("varying", [True, False])
def test_sweep_plots_match_jax(tmp_path, varying):
    res = _results(varying)
    got = plots.plot_sweep(res, str(tmp_path / "p"), prefix="quant")
    want = jax_plots.plot_sweep(res, str(tmp_path / "j"), prefix="quant")
    assert _names(got) == _names(want) and len(got) == 4
    got = plots.plot_metric_curves(res, str(tmp_path / "p"))
    want = jax_plots.plot_metric_curves(res, str(tmp_path / "j"))
    assert _names(got) == _names(want) and len(got) == 5
    assert all(os.path.getsize(p) > 0 for p in got)
    assert plots.plot_sweep({"boom": {"error": "x"}}, str(tmp_path)) == []


def test_sensitivity_plots_match_jax(tmp_path):
    agg = {"by_category": {"encoder_ffn": 0.4, "decoder_ffn": 0.9, "cross_attention": 0.2},
           "by_layer": {"encoder.0": 0.1, "encoder.1": 0.5, "decoder.0": 0.9,
                        "decoder.1": 0.3}}
    got = sens_plots.plot_sensitivity(agg, str(tmp_path / "p"))
    want = jax_sens_plots.plot_sensitivity(agg, str(tmp_path / "j"))
    assert _names(got) == _names(want) and len(got) == 2
    assert all(os.path.getsize(p) > 0 for p in got)


def test_plot_modules_import_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import openai_whisper_compression_tpu_torch.sweep.plots\n"
            "import openai_whisper_compression_tpu_torch.sensitivity.plots\n"
            "import openai_whisper_compression_tpu_torch.evaluation.eda\n"
            "import openai_whisper_compression_tpu_torch.evaluation.profiler\n"
            "from openai_whisper_compression_tpu_torch import cli\n"
            "import importlib.util as u\n"
            "u.find_spec = lambda name, *a: None\n"
            "assert cli._can_plot() is False\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "no plots written" in r.stdout
