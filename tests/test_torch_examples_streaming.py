"""The port's examples (`examples_torch/`) against the JAX package's
(`examples/`), part 3: `streaming_live` and `timestamps_and_profiling`.

Each JAX example runs in a subprocess (`PYTHONPATH` = the repository,
`JAX_PLATFORMS=cpu`) at its defaults; the port's `main(["--device",
"cpu"])` runs here at the same defaults on the same weights
(`torch_example_runs.same_weights`)."""

import pytest

from torch_example_runs import assert_lines_match, run_jax_example, same_weights


@pytest.fixture(autouse=True)
def _jax_weights(monkeypatch):
    same_weights(monkeypatch)


def test_streaming_live_matches_jax(capsys):
    """Every committed and pending text of the single stream (VAD on), its
    final text and segment count, and every pooled tick and final text equal
    to JAX's."""
    from examples_torch import streaming_live

    want = run_jax_example("streaming_live")
    got = streaming_live.main(["--device", "cpu"])
    assert_lines_match(want, capsys.readouterr().out)
    assert len(got["ticks"]) == len(got["single"]) and got["single_final"][1] > 0


def test_timestamps_and_profiling_matches_jax(capsys):
    """The long-form run's windows and segments (times and text), the size
    analysis, and the per-sample WER / CER summary equal to JAX's, the model
    size too; exempt: the device line (it names the device), the mean
    inference time (a clock) and the mean memory used (each package's own
    process measurement), and the temporary directory's name."""
    from examples_torch import timestamps_and_profiling

    want = run_jax_example("timestamps_and_profiling")
    got = timestamps_and_profiling.main(["--device", "cpu"])
    assert_lines_match(want, capsys.readouterr().out,
                       exempt=[r"^Using \w+ backend", r"avg_inference_time\.",
                               r"avg_memory_used\."],
                       subs=[(r"/tmp\S*", "<tmp>")])
    assert got["num_windows"] > 0 and got["segments"]
