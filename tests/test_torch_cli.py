"""The port's CLI (`cli.py`) against the JAX package's, sub-command by
sub-command on test2l: the counterparts of tests/test_agreement_cli.py and
of tests/test_sweep_cli.py's CLI cases.

Both CLIs get the same weights: the port's `init_params` is replaced, for
each test, by the JAX package's draws carried over with `from_numpy`, so
that `--model test2l --seed 0` means one tree on both sides (the CLI's own
path, `_load_model`, runs as written; `--weights` is held separately).
Every port call passes `--device cpu` (the CLI's default is the card).
Printed transcripts, the agreement metrics (mean KL and logit relative
error within 1e-5 absolute, as tests/test_torch_presets.py holds
`model_agreement`: f32 mels and logits summed in other orders), WER/CER, the analysis table, the
compressed file's sparsity line, the sensitivity recipe and the exported
state dicts are equal to JAX's. A real tokenizer is never looked for here
(`load_tokenizer` would reach for the hub): it raises if called."""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu import cli as jax_cli
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch import cli
from openai_whisper_compression_tpu_torch.evaluation import tokenizer as port_tok
from openai_whisper_compression_tpu_torch.models import params as P

DEV = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def same_weights(monkeypatch):
    def init_params(arch, seed=0, dtype=torch.float32, device="cuda"):
        jdt = {torch.float32: np.float32, torch.bfloat16: jax.numpy.bfloat16}[dtype]
        jp = JP.init_params(JAX_ARCHS[arch.name], jax.random.PRNGKey(seed), dtype=jdt)
        return P.from_numpy(jax.tree.map(np.asarray, jp), device=device)

    def no_hub(*a, **k):
        raise AssertionError("load_tokenizer called: it may reach the network")

    monkeypatch.setattr(P, "init_params", init_params)
    monkeypatch.setattr(port_tok, "load_tokenizer", no_hub)


def _both(capsys, argv, port_extra=()):
    """(JAX's return, JAX's stdout, the port's return, the port's stdout)."""
    jr = jax_cli.main(list(argv))
    jout = capsys.readouterr().out
    pr = cli.main(list(argv) + DEV + list(port_extra))
    pout = capsys.readouterr().out
    return jr, jout, pr, pout


def test_cli_agreement_matches_jax(capsys):
    argv = ["agreement", "--model", "test2l", "--quant", "quanto_int8", "--samples", "2"]
    _, jout, _, pout = _both(capsys, argv)
    j, p = json.loads(jout), json.loads(pout)
    assert p["quant"] == j["quant"]
    assert p["token_agreement"] == j["token_agreement"] > 0.9
    assert p["top1_agreement"] == j["top1_agreement"]
    for k in ("mean_kl", "logit_rel_err"):
        assert p[k] == pytest.approx(j[k], abs=1e-5), k


def _wav(path, sr=8000, seconds=0.7):
    t = np.arange(int(seconds * sr)) / sr
    mono = (0.3 * np.sin(2 * np.pi * 300 * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.stack([mono, mono], axis=1).reshape(-1).tobytes())


@pytest.mark.parametrize("kind", ["wav", "npy"])
def test_cli_transcribe_matches_jax(tmp_path, capsys, kind):
    if kind == "wav":   # 8 kHz stereo PCM: channel mix and resampling
        path = tmp_path / "a.wav"
        _wav(path)
    else:
        path = tmp_path / "a.npy"
        np.save(path, np.random.default_rng(0).standard_normal(8000).astype(np.float32))
    argv = ["transcribe", "--model", "test2l", "--audio", str(path),
            "--max-new-tokens", "3", "--batch-size", "1"]
    jr, jout, pr, pout = _both(capsys, argv)
    assert pout == jout and pr["text"] == jr["text"]


def test_cli_transcribe_writes_every_format_as_jax(tmp_path, capsys):
    path = tmp_path / "a.npy"
    np.save(path, np.random.default_rng(1).standard_normal(9000).astype(np.float32))
    argv = ["transcribe", "--model", "test2l", "--audio", str(path),
            "--max-new-tokens", "3", "--batch-size", "1", "-f", "all"]
    jax_cli.main(argv + ["-o", str(tmp_path / "jax")])
    cli.main(argv + ["-o", str(tmp_path / "port")] + DEV)
    capsys.readouterr()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 5
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def test_cli_transcribe_temperature_fallback_runs(tmp_path, capsys):
    path = tmp_path / "b.npy"
    np.save(path, (np.random.default_rng(0).standard_normal(8000) * 0.05).astype(np.float32))
    res = cli.main(["transcribe", "--model", "test2l", "--audio", str(path),
                    "--max-new-tokens", "3", "--batch-size", "1",
                    "--temperatures", "0,0.5"] + DEV)
    assert isinstance(res["text"], str) and res["text"] in capsys.readouterr().out


def test_cli_transcribe_continuous_matches_jax(tmp_path, capsys):
    d = tmp_path / "dir"
    d.mkdir()
    for i, n in enumerate((8000, 12000, 6000)):
        np.save(d / f"u{i}.npy", np.random.default_rng(i).standard_normal(n).astype(np.float32))
    argv = ["transcribe", "--model", "test2l", "--audio", str(d), "--continuous",
            "--max-new-tokens", "3", "--cb-slots", "2"]
    jr, _, pr, _ = _both(capsys, argv)
    assert pr == jr


def test_cli_evaluate_and_analyze_match_jax(tmp_path, capsys):
    argv = ["evaluate", "--model", "test2l", "--samples", "4", "--batch-size", "2",
            "--max-new-tokens", "4", "--quant", "quanto_int8"]
    jr, jout, pr, pout = _both(capsys, argv)
    assert "WER" in pout
    for k in ("wer", "cer", "num_samples"):
        assert pr[k] == jr[k], k
    jr, jout, pr, pout = _both(capsys, ["analyze", "--model", "test2l",
                                        "--save-path", str(tmp_path / "arch.csv")])
    # the carried-over tree lists its keys sorted (jax.tree.map's order), so
    # rows of equal size may come in another order
    assert "TOTAL" in pout and sorted(pout.splitlines()[:-1]) == sorted(jout.splitlines()[:-1])
    assert sorted(pr.pop("leaves"), key=lambda r: r["name"]) == \
        sorted(jr.pop("leaves"), key=lambda r: r["name"])
    assert pr == jr
    assert (tmp_path / "arch.csv").exists()


def test_cli_evaluate_data_aware_runs(capsys):
    scores = cli.main(["evaluate", "--model", "test2l", "--samples", "2",
                       "--batch-size", "2", "--max-new-tokens", "4",
                       "--calibration-samples", "2", "--quant", "gptq_int4"] + DEV)
    assert scores["num_samples"] == 2 and "WER" in capsys.readouterr().out


def test_cli_compress_verify_matches_jax(tmp_path, capsys):
    argv = ["compress", "--model", "test2l", "--verify", "--quant", "quanto_int8",
            "--save"]
    jax_cli.main(argv + [str(tmp_path / "j.zip")])
    jout = capsys.readouterr().out
    cli.main(argv + [str(tmp_path / "p.zip")] + DEV)
    pout = capsys.readouterr().out
    assert "roundtrip OK" in pout
    assert pout.splitlines()[0] == jout.splitlines()[0]     # sparsity and nnz
    from openai_whisper_compression_tpu.storage import formats as jax_formats

    back = jax_formats.load_sparse_zip(str(tmp_path / "p.zip"))
    want = jax_formats.load_sparse_zip(str(tmp_path / "j.zip"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_sensitivity_matches_jax(tmp_path, capsys):
    argv = ["sensitivity", "--model", "test2l", "--batches", "1", "--batch-size", "1",
            "--save-path"]
    jax_cli.main(argv + [str(tmp_path / "j" / "cfg.json")])
    cli.main(argv + [str(tmp_path / "p" / "cfg.json")] + DEV)
    capsys.readouterr()
    j = json.loads((tmp_path / "j" / "cfg.json").read_text())
    p = json.loads((tmp_path / "p" / "cfg.json").read_text())
    assert p["recipe"] == j["recipe"]
    assert sorted(x.name for x in (tmp_path / "p").iterdir()) == \
        sorted(x.name for x in (tmp_path / "j").iterdir())


def test_cli_export_matches_jax(tmp_path, capsys):
    """npz / pt / safetensors of a fresh, a quantized and a stored
    compressed model: the same names and values as JAX's export."""
    jax_cli.main(["compress", "--model", "test2l", "--save", str(tmp_path / "c.zip")])
    for out, extra in [("m.npz", []), ("q.pt", ["--quant", "quanto_int8"]),
                       ("m.safetensors", []), ("c.npz", ["--load", str(tmp_path / "c.zip")])]:
        argv = ["export", "--model", "test2l"] + extra + ["--out"]
        jax_cli.main(argv + [str(tmp_path / ("j_" + out))])
        cli.main(argv + [str(tmp_path / ("p_" + out))] + DEV)
        if out.endswith(".npz"):
            j, p = dict(np.load(tmp_path / ("j_" + out))), dict(np.load(tmp_path / ("p_" + out)))
        elif out.endswith(".pt"):
            j = torch.load(tmp_path / ("j_" + out), weights_only=True)
            p = torch.load(tmp_path / ("p_" + out), weights_only=True)
        else:
            from openai_whisper_compression_tpu_torch.models.convert import read_safetensors

            j = read_safetensors(str(tmp_path / ("j_" + out)))
            p = read_safetensors(str(tmp_path / ("p_" + out)))
        assert sorted(p) == sorted(j), out
        for k in j:
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(j[k]), err_msg=k)
    assert "exported" in capsys.readouterr().out


@pytest.mark.parametrize("ext", ["safetensors", "pt"])
def test_cli_weights_flag_loads_an_export(tmp_path, capsys, ext):
    """`--weights` reads an export through models/convert.py: the port's
    `_load_model` gives JAX's tree and inferred architecture."""
    import argparse

    out = str(tmp_path / f"m.{ext}")
    jax_cli.main(["export", "--model", "test2l", "--out", out])
    capsys.readouterr()
    args = argparse.Namespace(weights=out, dtype="float32", device="cpu")
    got, arch = cli._load_model(args)
    want, jarch = jax_cli._load_model(args)
    assert arch.replace(name=jarch.name) == arch and arch.vocab_size == jarch.vocab_size
    assert arch.d_model == jarch.d_model and arch.decoder_layers == jarch.decoder_layers
    for name, leaf in P.named_leaves(got):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(JP.get_leaf(want, name)),
                                      err_msg=name)


def _run_cfg(tmp_path, name, **over):
    cfg = {"model": "test2l",
           "decode": {"max_new_tokens": 4, "language_token_id": None,
                      "task_token_id": None, "notimestamps": False},
           "eval": {"num_samples": 2, "batch_size": 2, "warmup_batches": 0}}
    cfg.update(over)
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_run_config_matches_jax(tmp_path, capsys):
    over = {"dtype": "float32", "quantization": {"name": "quanto_int8"},
            "pruning": {"global_l1": 0.3}}
    jpath = _run_cfg(tmp_path, "j.json", eval={"num_samples": 4, "batch_size": 2,
                                              "warmup_batches": 0,
                                              "save_path": str(tmp_path / "j")}, **over)
    ppath = _run_cfg(tmp_path, "p.json", eval={"num_samples": 4, "batch_size": 2,
                                              "warmup_batches": 0,
                                              "save_path": str(tmp_path / "p")}, **over)
    js = jax_cli.main(["run", "--config", jpath])
    ps = cli.main(["run", "--config", ppath] + DEV)
    capsys.readouterr()
    assert ps["num_samples"] == js["num_samples"] == 4
    assert ps["wer"] == js["wer"] and ps["cer"] == js["cer"]
    assert (tmp_path / "p" / "test2l_results.json").exists()


def test_cli_run_data_aware_and_mixed(tmp_path, capsys):
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.quant import mixed
    from openai_whisper_compression_tpu_torch.sensitivity import gradient

    scores = cli.main(["run", "--config", _run_cfg(
        tmp_path, "da.json", quantization={"name": "gptq_int4"})] + DEV)
    assert scores["num_samples"] == 2
    arch = ARCHS["test2l"]
    params = P.init_params(arch, 0, device="cpu")
    batches = gradient.make_synthetic_batches(arch, n_batches=1, batch=2, seq=8)
    qcfg = mixed.generate_quant_config(
        params, gradient.compute_sensitivity(params, arch, batches), 6.0)
    qpath = mixed.save_quant_config(qcfg, str(tmp_path / "mixed.json"))
    scores = cli.main(["run", "--config", _run_cfg(
        tmp_path, "mx.json", quantization={"mixed_config": qpath})] + DEV)
    assert scores["num_samples"] == 2
    capsys.readouterr()


def test_cli_run_with_recovery(tmp_path, capsys):
    scores = cli.main(["run", "--config", _run_cfg(
        tmp_path, "qat.json", quantization={"name": "quanto_int2"},
        recovery={"qat": True, "steps": 2, "lr": 1e-3})] + DEV)
    assert scores["num_samples"] == 2
    scores = cli.main(["run", "--config", _run_cfg(
        tmp_path, "rec.json", pruning={"global_l1": 0.5},
        recovery={"steps": 2, "lr": 1e-3})] + DEV)
    assert scores["num_samples"] == 2
    with pytest.raises((KeyError, SystemExit)):
        cli.main(["run", "--config", _run_cfg(
            tmp_path, "bad.json", quantization={"name": "gptq_int4"},
            recovery={"qat": True, "steps": 1})] + DEV)
    capsys.readouterr()


def test_cli_distill_and_sweep_run(tmp_path, capsys):
    cli.main(["distill", "--model", "test2l", "--steps", "2", "--prune", "0.3",
              "--save-path", str(tmp_path / "d.npz")] + DEV)
    assert "sparsity preserved" in capsys.readouterr().out
    res = cli.main(["sweep", "--model", "test2l", "--samples", "2", "--batch-size", "2",
                    "--max-new-tokens", "3", "--limit", "2",
                    "--save-path", str(tmp_path / "sw")] + DEV)
    assert len(res) == 2 and all("error" not in r for r in res.values())
    assert any(p.suffix == ".png" for p in (tmp_path / "sw").iterdir())
    capsys.readouterr()


def test_cli_device_defaults_to_the_card():
    """Without --device the model is made on the card; with no card torch
    sees, that raises rather than running on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        cli.main(["analyze", "--model", "test2l"])
