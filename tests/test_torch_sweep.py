"""The port's compression sweeps (`sweep/configs.py`, `sweep/driver.py`,
the ladder of `sweep/curve.py`) against the JAX package on `test2l`, the same weights on
both sides (`init_params_jit`, carried over by `from_numpy`) and the same
synthetic datasets and word tokenizer.

- Every matrix: the same config names in the same order, the same
  calibration / data flags; every experimental config applies, to a tree
  of JAX's leaf names and shapes.
- `run_sweep`: fault isolation, the flushed `all_results.json`, resume
  under the fingerprint; the same keys as JAX's and equal deterministic
  fields (size, sparsity, GFLOPs, WER / CER, wer_vs_baseline and the
  transcripts, so the tokens) for a baseline, int8, int4 and 50% L1.
- `shard_configs` equal to JAX's, its rank from `torch.distributed`;
  `merge_host_results` and `summarize` equal to JAX's on the same files.

`sweep/curve.py` is held in `tests/test_torch_curve.py`."""

import json

import jax
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.config import EvalConfig as JaxEvalConfig
from openai_whisper_compression_tpu.evaluation.data import (
    prepare_datasets as jax_prepare_datasets)
from openai_whisper_compression_tpu.evaluation.tokenizer import WordTokenizer as JaxTok
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.sweep import configs as jax_configs
from openai_whisper_compression_tpu.sweep import curve as jax_curve
from openai_whisper_compression_tpu.sweep import driver as jax_driver
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig, EvalConfig
from openai_whisper_compression_tpu_torch.evaluation.data import prepare_datasets
from openai_whisper_compression_tpu_torch.evaluation.tokenizer import WordTokenizer
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
from openai_whisper_compression_tpu_torch.quant import api
from openai_whisper_compression_tpu_torch.sweep import configs, curve, driver

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]


@pytest.fixture(scope="module")
def setup():
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    return (jp, tp, jax_prepare_datasets(num_cal=2, num_test=4, seed=0),
            prepare_datasets(num_cal=2, num_test=4, seed=0),
            JaxTok(J_ARCH.vocab_size, special_start=997),
            WordTokenizer(ARCH.vocab_size, special_start=997))


def _dc(cls=DecodeConfig, **kw):
    kw.setdefault("max_new_tokens", 4)
    return cls(language_token_id=None, task_token_id=None, notimestamps=False, **kw)


def _eval(cls=EvalConfig):
    return cls(batch_size=2, warmup_batches=0)


def _run_both(setup, port_cfgs, jax_cfgs, tmp_path, **kw):
    jp, tp, jds, tds, jtok, ttok = setup
    t = driver.run_sweep(tp, ARCH, port_cfgs, tds, ttok, eval_cfg=_eval(), decode_cfg=_dc(),
                         save_path=str(tmp_path / "port"), device=DEV, **kw)
    j = jax_driver.run_sweep(jp, J_ARCH, jax_cfgs, jds, jtok, eval_cfg=_eval(JaxEvalConfig),
                             decode_cfg=_dc(JaxDecodeConfig), save_path=str(tmp_path / "jax"),
                             **kw)
    return t, j


SCORE_FIELDS = ("num_samples", "wer", "cer", "total_audio_duration_s", "batch_size",
                "split", "normalizer", "wer_vs_baseline", "exact_match_vs_baseline")


def _assert_results_match(t, j, tmp_path, quantized=(), dense=None):
    """The same configs and keys; equal sizes, sparsity, GFLOPs, scores
    and transcripts; errors where JAX has them. The `quantized` configs'
    GFLOPs are the `dense` config's: the port counts a quantized linear's
    products dense, where JAX counts none (the reference defect of its
    `prune/flops.py::_nnz`)."""
    assert list(t) == list(j)
    for name, te in t.items():
        je = j[name]
        assert set(te) == set(je), name
        if "error" in je:
            assert te["error"] == je["error"], name
            continue
        for f in ("model_size_mb", "sparsity", "gflops"):
            want = j[dense][f] if (f == "gflops" and name in quantized) else je[f]
            assert te[f] == pytest.approx(want, rel=1e-12, abs=0), (name, f)
        assert list(te["splits"]) == list(je["splits"])
        for split, ts in te["splits"].items():
            js = je["splits"][split]
            # the port's evaluate_model also lists each batch's latency
            assert set(ts) - {"batch_latencies_s"} == set(js), (name, split)
            for f in SCORE_FIELDS:
                assert ts.get(f) == js.get(f), (name, split, f)
            with open(tmp_path / "port" / f"{name}_{split}_transcriptions.json") as f1, \
                    open(tmp_path / "jax" / f"{name}_{split}_transcriptions.json") as f2:
                assert json.load(f1) == json.load(f2), (name, split)


# ---------------------------------------------------------------- matrices

def test_config_names_and_order_match_jax():
    assert list(configs.SWEEPS) == list(jax_configs.SWEEPS)
    for key, make in configs.SWEEPS.items():
        got, want = make(ARCH), jax_configs.SWEEPS[key](J_ARCH)
        assert [c["name"] for c in got] == [c["name"] for c in want], key
        for g, w in zip(got, want):
            assert ({k: v for k, v in g.items() if k != "apply"}
                    == {k: v for k, v in w.items() if k != "apply"}), (key, g["name"])
    assert len(configs.quant_sweep()) == 22
    assert len(configs.unstructured_l1_sweep()) == 12
    assert len(configs.prune_quant_sweep()) == 18
    assert [n for n, *_ in curve.ladder("int8")] == [n for n, *_ in jax_curve.ladder("int8")]


def test_experimental_configs_all_apply(setup):
    """Every experimental config applies to test2l and gives a tree of the
    leaf names and shapes JAX's gives; the input tree is left alone."""
    jp, tp = setup[:2]
    before = {n: t.clone() for n, t in P.named_leaves(tp)}
    for g, w in zip(configs.experimental_pruning_sweep(ARCH),
                    jax_configs.experimental_pruning_sweep(J_ARCH)):
        out, jout = g["apply"](tp, ARCH), w["apply"](jp, J_ARCH)
        assert isinstance(out, dict) and "encoder" in out, g["name"]
        got = {n: tuple(leaf.shape) for n, leaf in P.named_leaves(out)}
        want = {n: tuple(np.shape(leaf)) for n, leaf in JP.named_leaves(jout)}
        assert got == want, g["name"]
    assert all(torch.equal(t, before[n]) for n, t in P.named_leaves(tp))


# ---------------------------------------------------------------- the driver

def _quant(name):
    return lambda p, a: p if name == "baseline" else (
        api.quantize_params(p, name))


def _jquant(name):
    from openai_whisper_compression_tpu.quant import api as jax_api

    return lambda p, a: p if name == "baseline" else jax_api.quantize_params(p, name)


def test_run_sweep_fault_isolation_matches_jax(setup, tmp_path):
    names = ("baseline", "int8")
    t, j = _run_both(
        setup,
        [{"name": n, "apply": _quant(n)} for n in names] + [
            {"name": "boom", "apply": lambda p, a: 1 / 0}],
        [{"name": n, "apply": _jquant(n)} for n in names] + [
            {"name": "boom", "apply": lambda p, a: 1 / 0}],
        tmp_path)
    assert set(t) == {"baseline", "int8", "boom"} and "error" in t["boom"]
    assert t["int8"]["model_size_mb"] < t["baseline"]["model_size_mb"]
    s_int8 = t["int8"]["splits"]["test_clean"]
    assert isinstance(s_int8["wer_vs_baseline"], float)
    assert "wer_vs_baseline" not in t["baseline"]["splits"]["test_clean"]
    _assert_results_match(t, j, tmp_path, quantized={"int8"}, dense="baseline")
    saved = json.loads((tmp_path / "port" / "all_results.json").read_text())
    jsaved = json.loads((tmp_path / "jax" / "all_results.json").read_text())
    assert saved["_meta"] == jsaved["_meta"] and "boom" in saved
    out = driver.summarize(t)
    assert "baseline" in out and "ERROR" in out


def test_run_sweep_matrix_configs_match_jax(setup, tmp_path):
    """The chip's sweep configs (a baseline, quanto int8 and int4, 50%
    global L1) through both drivers: every deterministic field equal."""
    want = {"baseline_bf16", "quanto_int8", "quanto_int4", "l1_global_50pct"}
    pick = [c for c in configs.quant_sweep() + configs.unstructured_l1_sweep()
            if c["name"] in want]
    jpick = [c for c in jax_configs.quant_sweep() + jax_configs.unstructured_l1_sweep()
             if c["name"] in want]
    t, j = _run_both(setup, pick, jpick, tmp_path)
    assert all("error" not in e for e in t.values()), t
    _assert_results_match(t, j, tmp_path, quantized={"quanto_int8", "quanto_int4"},
                          dense="baseline_bf16")


def test_run_sweep_resume(setup, tmp_path):
    """Completed configs are skipped on a rerun, failed ones retried,
    results flushed after every config; a changed decode configuration
    (another fingerprint) reruns everything, as does resume=False."""
    _, tp, _, tds, _, ttok = setup
    calls = {"good": 0, "flaky": 0}

    def good(p, a):
        calls["good"] += 1
        return p

    def flaky(p, a):
        calls["flaky"] += 1
        if calls["flaky"] == 1:
            raise RuntimeError("transient")
        return p

    cfgs = [{"name": "good", "apply": good}, {"name": "flaky", "apply": flaky}]
    kw = dict(eval_cfg=_eval(), decode_cfg=_dc(), save_path=str(tmp_path), device=DEV)
    r1 = driver.run_sweep(tp, ARCH, cfgs, tds, ttok, **kw)
    assert "error" in r1["flaky"] and "error" not in r1["good"]
    saved = json.loads((tmp_path / "all_results.json").read_text())
    assert set(saved) == {"good", "flaky", "_meta"} and "_meta" not in r1
    r2 = driver.run_sweep(tp, ARCH, cfgs, tds, ttok, **kw)
    assert calls == {"good": 1, "flaky": 2} and "error" not in r2["flaky"]
    driver.run_sweep(tp, ARCH, cfgs, tds, ttok, **{**kw, "decode_cfg": _dc(max_new_tokens=5)})
    assert calls["good"] == 2
    r3 = driver.run_sweep(tp, ARCH, cfgs, tds, ttok, resume=False, **kw)
    assert calls["good"] == 3 and "error" not in r3["flaky"]


def test_data_aware_and_calibrated_configs_through_driver(setup, tmp_path):
    """GPTQ, SmoothQuant and AWQ take the calibration split through the
    driver; a static configuration is calibrated on it (`act_scale` set)."""
    _, tp, _, tds, _, ttok = setup
    cfgs = configs.data_aware_sweep()
    assert [c["name"] for c in cfgs] == [c["name"] for c in jax_configs.data_aware_sweep()]
    want = {"baseline_fp32", "gptq_int8", "smoothquant_w8a8", "awq_int4"}
    sub = [c for c in cfgs if c["name"] in want]
    static = next(c for c in configs.quant_sweep() if c["name"] == "static_int8_act_int8")
    seen = {}
    real_apply = static["apply"]

    def spy(p, a):
        seen["tree"] = real_apply(p, a)
        return seen["tree"]

    res = driver.run_sweep(tp, ARCH, sub + [{**static, "apply": spy}], tds, ttok,
                           eval_cfg=_eval(), decode_cfg=_dc(), save_path=str(tmp_path),
                           device=DEV)
    for n in want | {"static_int8_act_int8"}:
        assert "error" not in res[n], res[n]
        assert res[n]["splits"]["test_clean"]["wer"] is not None
    assert res["gptq_int8"]["model_size_mb"] < res["baseline_fp32"]["model_size_mb"]
    assert all(leaf.act_scale is None for _, leaf in P.named_leaves(seen["tree"])
               if isinstance(leaf, QTensor))   # the driver calibrates a copy


def test_shard_configs_matches_jax(monkeypatch):
    cfgs = [{"name": "baseline_fp32"}] + [{"name": f"c{i}"} for i in range(7)]
    pct = [{"name": f"l1_global_{p}pct"} for p in (0, 10, 30, 50, 90)]
    for cs in (cfgs, cfgs[1:], pct):
        for n in (1, 2, 3):
            for i in range(n):
                assert ([c["name"] for c in driver.shard_configs(cs, i, n)]
                        == [c["name"] for c in jax_driver.shard_configs(cs, i, n)])
                assert ([c["name"] for c in driver.shard_configs(cs, i, n, False)]
                        == [c["name"] for c in jax_driver.shard_configs(cs, i, n, False)])
    with pytest.raises(ValueError, match="outside"):
        driver.shard_configs(cfgs, process_id=3, num_processes=3)
    assert driver.shard_configs(cfgs) == cfgs       # no process group: 0 of 1
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert driver.shard_configs(cfgs) == jax_driver.shard_configs(cfgs, 1, 3)


def test_merge_host_results(setup, tmp_path):
    """Two processes' shards of the quantization matrix, merged; JAX's
    merge of the same files gives the same result."""
    _, tp, _, tds, _, ttok = setup
    cfgs = configs.quant_sweep()[:5]
    for pid in range(2):
        driver.run_sweep(tp, ARCH, driver.shard_configs(cfgs, pid, 2), tds, ttok,
                         eval_cfg=_eval(), decode_cfg=_dc(),
                         save_path=str(tmp_path / f"host{pid}"), device=DEV)
    merged = driver.merge_host_results(str(tmp_path))
    assert set(merged) == {c["name"] for c in cfgs}
    assert all("error" not in e for e in merged.values())
    on_disk = json.loads((tmp_path / "all_results.json").read_text())
    assert set(on_disk) == set(merged) | {"_meta"}
    assert jax_driver.merge_host_results(str(tmp_path), "jax.json") == merged
    assert driver.summarize(merged) == jax_driver.summarize(merged)
    with pytest.raises(FileNotFoundError):
        driver.merge_host_results(str(tmp_path / "nope"))
    bad = tmp_path / "host1" / "all_results.json"
    res = json.loads(bad.read_text())
    res["_meta"] = {"fingerprint": "other"}
    bad.write_text(json.dumps(res))
    with pytest.raises(ValueError, match="refusing"):
        driver.merge_host_results(str(tmp_path))
