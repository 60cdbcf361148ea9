"""The port's examples (`examples_torch/`) against the JAX package's
(`examples/`), part 1: `compress_store_serve` and `qat_recovery`.

Each JAX example runs in a subprocess (`PYTHONPATH` = the repository,
`JAX_PLATFORMS=cpu`) at its defaults; the port's `main(["--device",
"cpu"])` runs here at the same defaults on the same weights
(`torch_example_runs.same_weights`). Every printed line must be equal, but
for a temporary path, and for the floats that the port's arithmetic may
move, each held within the tolerance stated beside it."""

import pytest

from torch_example_runs import assert_lines_match, run_jax_example, same_weights

TMP = (r"/tmp\S*", "<tmp>")


@pytest.fixture(autouse=True)
def _jax_weights(monkeypatch):
    same_weights(monkeypatch)


def test_compress_store_serve_matches_jax(capsys):
    """Sizes, the analysis table, the sparsity, the token agreement, the
    file size on disk, the round trip and the transcript equal to JAX's;
    the mean KL of the compressed model within 1e-5 relative (f32 logits
    summed in another order; printed to three digits, so one unit of the
    last, 1e-5 at 1e-3, more)."""
    from examples_torch import compress_store_serve

    want = run_jax_example("compress_store_serve")
    got = compress_store_serve.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert_lines_match(want, out, subs=[TMP],
                       close={r"== fidelity": [None, (1e-5, 1e-5)]})
    assert got["roundtrip_ok"] and got["num_chunks"] == 2
    assert f"token_agreement={got['token_agreement']:.3f}" in want


def test_qat_recovery_matches_jax(capsys):
    """One-shot PTQ and recovery distillation equal to JAX's as printed
    (token agreement, mean KL and logit error to four digits); QAT's token
    agreement equal, its losses, mean KL and logit error within 10%
    relative (and one unit of the last printed digit): 40 Adam steps on
    straight-through int2 fake quantization, where a last-bit difference of
    a latent weight (f32 sums in another order) moves a code a whole step,
    so the two trainings part gradually: the first steps' losses agree to
    3e-7 relative, the fortieth to ~4%."""
    from examples_torch import qat_recovery

    want = run_jax_example("qat_recovery")
    got = qat_recovery.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert_lines_match(want, out, close={
        r"^# qat loss": [(1e-5, 1e-4), (0.1, 1e-4)],
        r"^qat ": [None, (0.1, 1e-4), (0.1, 1e-4)]})
    assert len(got["qat_loss"]) == 40
    assert got["qat"]["mean_kl"] <= got["ptq"]["mean_kl"]
