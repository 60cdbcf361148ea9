"""The port's checkpoint conversion (`models/convert.py`) and
`load_model(hf=)` against the JAX package on `test2l`, the same trees on
both sides (`init_params_jit`, carried over by `from_numpy`).

- The ingestion cases of `tests/test_checkpoint_ingest.py` (safetensors,
  OpenAI `.pt`, bare state dicts, shape inference of the official family,
  HF directories with a generation config, sharded, a missing shard, no
  config, the mounted HF cache and `load_hf_model`) and
  `test_arch_from_hf_config_special_layouts`.
- `to_hf_state_dict` / `to_openai_checkpoint` equal to JAX's; safetensors
  written by either package read by the other (byte-equal files: the
  format carries no timestamp), bf16 and f16 included.
- `load_model(hf=dir)` equal to JAX's `load_model(hf=dir)` (which reads
  the directory through transformers), and greedy tokens equal; the
  refusal of a name found in neither cache (the port fetches nothing).

Every comparison is bit for bit."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openai_whisper_compression_tpu as jax_pkg
import openai_whisper_compression_tpu_torch as pkg
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
from openai_whisper_compression_tpu.evaluation.harness import (
    make_transcribe_fn as jax_make_transcribe_fn)
from openai_whisper_compression_tpu.models import convert as jax_convert
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
from openai_whisper_compression_tpu_torch.models import convert
from openai_whisper_compression_tpu_torch.models import params as P

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, A2 = JAX_ARCHS["test2l"], ARCHS["test2l"]


@pytest.fixture(scope="module")
def tree():
    """(port tree, HF state dict of it, JAX tree) of test2l, seed 3."""
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(3))
    params = P.from_numpy(jax.tree.map(np.asarray, jp), device=DEV)
    return params, convert.to_hf_state_dict(params), jp


@pytest.fixture(autouse=True)
def _no_outside_caches(tmp_path, monkeypatch):
    """Every cache lookup of both packages stays inside the test's directory."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "no-hub"))
    monkeypatch.setenv("WHISPER_TPU_CACHE", str(tmp_path / "npz-cache"))
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_tree_equal(a, b):
    """Two port trees, or a port tree and a JAX tree, equal leaf for leaf
    (names, dtypes, values)."""
    la = dict(P.named_leaves(a))
    lb = dict(P.named_leaves(b)) if isinstance(P.named_leaves(b)[0][1], torch.Tensor) \
        else dict(JP.named_leaves(b))
    assert sorted(la) == sorted(lb)
    for n, x in la.items():
        y = lb[n]
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), n
        else:
            assert str(x.dtype).removeprefix("torch.") == str(np.asarray(y).dtype), n
            np.testing.assert_array_equal(_np(x.float() if x.dtype == torch.bfloat16 else x),
                                          _np(y), err_msg=n)
        assert x.is_contiguous(), n


def _same_arch(a, b) -> bool:
    """Archs of either package with equal fields."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _config_json(arch):
    return {
        "vocab_size": arch.vocab_size, "num_mel_bins": arch.num_mel_bins,
        "d_model": arch.d_model, "encoder_layers": arch.encoder_layers,
        "encoder_attention_heads": arch.encoder_heads,
        "decoder_layers": arch.decoder_layers,
        "decoder_attention_heads": arch.decoder_heads,
        "encoder_ffn_dim": arch.ffn_dim, "decoder_ffn_dim": arch.ffn_dim,
        "max_source_positions": arch.max_source_positions,
        "max_target_positions": arch.max_target_positions,
        "eos_token_id": arch.eos_token_id, "pad_token_id": arch.eos_token_id,
        "bos_token_id": arch.eos_token_id,
        "decoder_start_token_id": arch.decoder_start_token_id,
    }


def _write_config(d, arch=A2):
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(_config_json(arch), f)


# ---------------------------------------------------------------- safetensors

def test_safetensors_roundtrip(tmp_path, tree):
    _, sd, _ = tree
    p = str(tmp_path / "model.safetensors")
    convert.write_safetensors(sd, p)
    back = convert.read_safetensors(p)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].device.type == "cpu" and torch.equal(back[k], sd[k]), k


def test_safetensors_bf16_and_f16_either_package(tmp_path):
    """bf16 (through torch here, ml_dtypes in JAX), f16 and int64: each
    package reads the other's file, and the two files are byte-equal."""
    import ml_dtypes

    sd = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16() / 7,
          "b": torch.full((4,), 0.3, dtype=torch.float16),
          "c": torch.arange(3, dtype=torch.int64)}
    jsd = {"a": sd["a"].float().numpy().astype(ml_dtypes.bfloat16),
           "b": sd["b"].numpy(), "c": sd["c"].numpy()}
    p, jpath = str(tmp_path / "t.safetensors"), str(tmp_path / "j.safetensors")
    convert.write_safetensors(sd, p)
    jax_convert.write_safetensors(jsd, jpath)
    with open(p, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    back = convert.read_safetensors(jpath)
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], sd["a"])
    assert back["b"].dtype == torch.float16 and torch.equal(back["b"], sd["b"])
    assert back["c"].dtype == torch.int64 and torch.equal(back["c"], sd["c"])
    jback = jax_convert.read_safetensors(p)
    assert jback["a"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jback["a"].astype(np.float32), sd["a"].float().numpy())
    np.testing.assert_array_equal(jback["b"], jsd["b"])
    np.testing.assert_array_equal(jback["c"], jsd["c"])
    with pytest.raises(ValueError, match="unsupported"):
        convert.write_safetensors({"x": torch.zeros(2, dtype=torch.complex64)},
                                  str(tmp_path / "x.safetensors"))


def test_bare_safetensors_with_sibling_config(tmp_path, tree):
    params, sd, _ = tree
    p = str(tmp_path / "model.safetensors")
    convert.write_safetensors(sd, p)
    _write_config(tmp_path)
    loaded, arch = convert.load_checkpoint(p, device=DEV)
    _assert_tree_equal(loaded, params)
    assert (arch.d_model, arch.encoder_heads) == (A2.d_model, A2.encoder_heads)


# ------------------------------------------------------ HF and OpenAI exports

def test_to_hf_and_openai_match_jax(tree):
    """`to_hf_state_dict` and `to_openai_checkpoint` of the same tree equal
    JAX's: names, shapes, values and dims; the tied projection shares the
    embedding."""
    params, sd, jp = tree
    jsd = jax_convert.to_hf_state_dict(jp)
    assert list(sd) == list(jsd)
    for k, v in sd.items():
        assert v.is_contiguous() and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsd[k]), err_msg=k)
    assert sd["proj_out.weight"] is sd["model.decoder.embed_tokens.weight"]
    ck = convert.to_openai_checkpoint(params, A2)
    jck = jax_convert.to_openai_checkpoint(jp, J_ARCH)
    assert ck["dims"] == jck["dims"]
    assert list(ck["model_state_dict"]) == list(jck["model_state_dict"])
    for k, v in ck["model_state_dict"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jck["model_state_dict"][k]))
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv

    with pytest.raises(ValueError, match="dequantize"):
        convert.to_hf_state_dict(quantize_params(params, "int8"))
    with pytest.raises(ValueError, match="unfuse"):
        convert.to_hf_state_dict(fuse_qkv(params))


def test_from_hf_state_dict_matches_jax(tree):
    params, sd, jp = tree
    _assert_tree_equal(convert.from_hf_state_dict(sd), params)
    jsd = jax_convert.to_hf_state_dict(jp)   # numpy arrays in, as JAX takes them
    _assert_tree_equal(convert.from_hf_state_dict(jsd), jp)


def test_openai_pt_roundtrip(tmp_path, tree):
    params, _, _ = tree
    ckpt = convert.to_openai_checkpoint(params, A2)
    assert ckpt["dims"]["n_audio_state"] == A2.d_model
    assert any(".blocks." in k for k in ckpt["model_state_dict"])
    assert "decoder.token_embedding.weight" in ckpt["model_state_dict"]
    p = str(tmp_path / "test2l.pt")
    torch.save(ckpt, p)
    loaded, arch = convert.load_checkpoint(p, device=DEV)
    _assert_tree_equal(loaded, params)
    assert arch.encoder_layers == A2.encoder_layers
    assert arch.max_target_positions == A2.max_target_positions
    assert arch.ffn_dim == A2.ffn_dim
    jloaded, jarch = jax_convert.load_checkpoint(p)   # the port's .pt, read by JAX
    _assert_tree_equal(loaded, jloaded)
    assert _same_arch(arch, jarch)


def test_openai_name_mapping_bijective(tree):
    _, sd, _ = tree
    oai = convert.hf_to_openai_names(sd)
    assert list(oai) == list(jax_convert.hf_to_openai_names(sd))
    back = convert.openai_to_hf_names(oai)
    assert set(back) == {k.removeprefix("model.") for k in sd} - {"proj_out.weight"}


def test_bare_torch_state_dict_hf_names(tmp_path, tree):
    params, sd, _ = tree
    p = str(tmp_path / "export.pt")
    torch.save({"state_dict": dict(sd)}, p)
    loaded, arch = convert.load_checkpoint(p, device=DEV)
    _assert_tree_equal(loaded, params)
    assert arch.d_model == A2.d_model


def test_load_checkpoint_casts_before_the_device(tmp_path, tree):
    """dtype= casts the floating leaves (the same as JAX's tree_cast)."""
    params, sd, jp = tree
    convert.write_safetensors(sd, str(tmp_path / "model.safetensors"))
    _write_config(tmp_path)
    loaded, _ = convert.load_checkpoint(str(tmp_path), dtype=torch.bfloat16, device=DEV)
    jloaded, _ = jax_convert.load_checkpoint(str(tmp_path), dtype=jnp.bfloat16)
    _assert_tree_equal(loaded, jloaded)
    assert loaded["decoder"]["embed"].dtype == torch.bfloat16


# ------------------------------------------------------------ arch inference

def _fake_sd_for(arch):
    """Shape-only HF state dict for arch (zeros; inference reads shapes)."""
    d, f, m = arch.d_model, arch.ffn_dim, arch.num_mel_bins
    sd = {
        "model.encoder.conv1.weight": torch.zeros((d, m, 3)),
        "model.encoder.embed_positions.weight": torch.zeros((arch.max_source_positions, d)),
        "model.decoder.embed_tokens.weight": torch.zeros((arch.vocab_size, d)),
        "model.decoder.embed_positions.weight": torch.zeros((arch.max_target_positions, d)),
    }
    for i in range(arch.encoder_layers):
        sd[f"model.encoder.layers.{i}.fc1.weight"] = torch.zeros((f, d))
    for i in range(arch.decoder_layers):
        sd[f"model.decoder.layers.{i}.fc1.weight"] = torch.zeros((f, d))
    return sd


@pytest.mark.parametrize("name", ["tiny", "small", "large-v3", "large-v3-turbo", "tiny.en"])
def test_infer_arch_official_family(name):
    a = ARCHS[name]
    sd = _fake_sd_for(a)
    got = convert.infer_arch_from_state_dict(sd)
    assert got.d_model == a.d_model
    assert got.encoder_heads == a.encoder_heads  # a family match, not // 64
    assert got.decoder_layers == a.decoder_layers
    assert got.vocab_size == a.vocab_size
    assert got.eos_token_id == a.eos_token_id
    assert got.no_timestamps_token_id == a.no_timestamps_token_id
    assert got.multilingual == a.multilingual
    assert _same_arch(got, jax_convert.infer_arch_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}))


def test_arch_from_hf_config_special_layouts():
    """The vocab size sets the special-token layout, as JAX's."""
    from types import SimpleNamespace

    def cfg(vocab):
        return SimpleNamespace(
            name_or_path="x", vocab_size=vocab, num_mel_bins=80, d_model=64,
            encoder_layers=2, encoder_attention_heads=4, decoder_layers=2,
            decoder_attention_heads=4, encoder_ffn_dim=128,
            max_source_positions=64, max_target_positions=32,
            eos_token_id=50257, decoder_start_token_id=50258)

    a_en = convert.arch_from_hf_config(cfg(51864))
    assert (a_en.multilingual, a_en.no_timestamps_token_id) == (False, 50362)
    a_v2 = convert.arch_from_hf_config(cfg(51865))
    assert (a_v2.multilingual, a_v2.no_timestamps_token_id) == (True, 50363)
    a_v3 = convert.arch_from_hf_config(cfg(51866))
    assert (a_v3.multilingual, a_v3.no_timestamps_token_id) == (True, 50364)
    a_t = convert.arch_from_hf_config(cfg(1000))
    assert a_t.no_timestamps_token_id >= a_t.vocab_size
    for v in (51864, 51865, 51866, 1000):
        assert _same_arch(convert.arch_from_hf_config(cfg(v)),
                          jax_convert.arch_from_hf_config(cfg(v)))
    dims = {"n_mels": 128, "n_vocab": 51866, "n_audio_ctx": 1500, "n_audio_state": 1280,
            "n_audio_head": 20, "n_audio_layer": 32, "n_text_ctx": 448,
            "n_text_state": 1280, "n_text_head": 20, "n_text_layer": 4}
    assert _same_arch(convert.arch_from_openai_dims(dims),
                      jax_convert.arch_from_openai_dims(dims))


def test_small_config_gives_small_arch():
    """whisper-small's config.json fields give `ARCHS["small"]`'s widths."""
    from types import SimpleNamespace

    s = ARCHS["small"]
    got = convert.arch_from_hf_config(SimpleNamespace(**_config_json(s)))
    assert got.replace(name=s.name) == s


# ----------------------------------------------------------------- HF layout

def test_hf_dir_with_generation_config(tmp_path, tree):
    params, sd, _ = tree
    convert.write_safetensors(sd, str(tmp_path / "model.safetensors"))
    _write_config(tmp_path)
    with open(tmp_path / "generation_config.json", "w") as f:
        json.dump({"alignment_heads": [[1, 0], [1, 2]], "no_timestamps_token_id": 999}, f)
    loaded, arch = convert.load_checkpoint(str(tmp_path), device=DEV)
    _assert_tree_equal(loaded, params)
    assert arch.alignment_heads == ((1, 0), (1, 2))
    assert arch.no_timestamps_token_id == 999
    assert _same_arch(arch, jax_convert.load_checkpoint(str(tmp_path))[1])


def _write_sharded(d, sd):
    keys = sorted(sd)
    half = len(keys) // 2
    shards = {"model-00001-of-00002.safetensors": keys[:half],
              "model-00002-of-00002.safetensors": keys[half:]}
    weight_map = {}
    for fname, ks in shards.items():
        convert.write_safetensors({k: sd[k] for k in ks}, os.path.join(d, fname))
        weight_map.update({k: fname for k in ks})
    total = sum(v.numel() * v.element_size() for v in sd.values())
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)


def test_hf_dir_sharded(tmp_path, tree):
    params, sd, jp = tree
    _write_sharded(str(tmp_path), sd)
    _write_config(tmp_path)
    loaded, _ = convert.load_checkpoint(str(tmp_path), device=DEV)
    _assert_tree_equal(loaded, params)
    _assert_tree_equal(loaded, jax_convert.load_checkpoint(str(tmp_path))[0])


def test_hf_dir_missing_shard_is_loud(tmp_path):
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"x": "model-00001-of-00002.safetensors"}}, f)
    with pytest.raises(FileNotFoundError, match="missing"):
        convert.load_checkpoint(str(tmp_path), device=DEV)


def test_hf_dir_without_config_infers(tmp_path):
    """A partly populated snapshot: weights only, no config.json."""
    a = ARCHS["tiny"]
    convert.write_safetensors(_fake_sd_for(a), str(tmp_path / "probe.safetensors"))
    _, arch = convert._read_hf_dir(str(tmp_path))
    assert arch.encoder_heads == a.encoder_heads


def _snapshot(root, sd, name="models--openai--whisper-test2l", snap="abc123"):
    d = os.path.join(root, name, "snapshots", snap)
    os.makedirs(d)
    convert.write_safetensors(sd, os.path.join(d, "model.safetensors"))
    _write_config(d)
    return d


def test_find_in_hf_cache(tmp_path, tree, monkeypatch):
    params, sd, _ = tree
    snap = _snapshot(str(tmp_path), sd)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    found = convert.find_in_hf_cache("openai/whisper-test2l")
    assert found == snap == jax_convert.find_in_hf_cache("openai/whisper-test2l")
    assert convert.find_in_hf_cache("openai/whisper-nonexistent") is None
    loaded, _ = convert.load_checkpoint(found, device=DEV)
    _assert_tree_equal(loaded, params)


def test_load_hf_model_uses_mounted_cache(tmp_path, tree, monkeypatch):
    """`load_hf_model` resolves a mounted HF cache, writes the npz cache
    (the JAX package's file, which JAX's `load_cached_model` reads back),
    and the next call takes the npz cache."""
    params, sd, jp = tree
    _snapshot(str(tmp_path / "hub"), sd)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    loaded, arch = convert.load_hf_model("openai/whisper-test2l", device=DEV)
    _assert_tree_equal(loaded, params)
    assert arch.name == "openai/whisper-test2l"
    assert os.path.exists(convert._cache_paths("openai/whisper-test2l", None)[0])
    jhit = jax_convert.load_cached_model("openai/whisper-test2l")
    assert jhit is not None and _same_arch(jhit[1], arch)
    _assert_tree_equal(loaded, jhit[0])
    # the npz cache now answers even with the HF cache gone
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "gone"))
    again, arch2 = convert.load_hf_model("openai/whisper-test2l", dtype=torch.bfloat16,
                                         device=DEV)
    assert arch2 == arch and again["decoder"]["embed"].dtype == torch.bfloat16
    got, _ = pkg.load_model(hf="openai/whisper-test2l", device=DEV)
    _assert_tree_equal(got, params)


def test_load_hf_model_refuses_when_both_caches_miss(tmp_path):
    with pytest.raises(FileNotFoundError, match="neither checkpoint cache") as e:
        convert.load_hf_model("openai/whisper-absent", device=DEV)
    assert str(tmp_path / "npz-cache") in str(e.value)
    assert str(tmp_path / "no-hub") in str(e.value)
    with pytest.raises(FileNotFoundError, match="neither"):
        pkg.load_model(hf="openai/whisper-absent", device=DEV)


# --------------------------------------------------------- load_model(hf=dir)

def test_load_model_hf_dir_matches_jax(tmp_path, tree):
    """`load_model(hf=dir)` of a bf16 two-shard snapshot with its
    generation config: the same tree and arch fields as JAX's
    `load_model(hf=dir)` (transformers' `from_pretrained` there), then
    greedy tokens equal on test2l."""
    _, sd, _ = tree
    d = tmp_path / "snap"
    d.mkdir()
    _write_sharded(str(d), {k: v.bfloat16() for k, v in sd.items()})
    _write_config(d)
    with open(d / "generation_config.json", "w") as f:
        json.dump({"alignment_heads": [[1, 0], [1, 3]], "no_timestamps_token_id": 999}, f)
    params, arch = pkg.load_model(hf=str(d), device=DEV)
    jparams, jarch = jax_pkg.load_model(hf=str(d))
    _assert_tree_equal(params, jparams)
    assert params["decoder"]["embed"].dtype == torch.float32
    for f in ("vocab_size", "d_model", "encoder_layers", "encoder_heads", "decoder_layers",
              "decoder_heads", "ffn_dim", "max_source_positions", "max_target_positions",
              "eos_token_id", "decoder_start_token_id", "no_timestamps_token_id",
              "alignment_heads", "multilingual"):
        assert getattr(arch, f) == getattr(jarch, f), f
    assert arch.name == str(d)
    cfg = dict(max_new_tokens=8, kv_int8=True, cross_kv_int8=True)
    wav = (np.random.default_rng(4).standard_normal((2, 20480)) * 0.1).astype(np.float32)
    tt, tl = make_transcribe_fn(arch, DecodeConfig(**cfg), device=DEV)(params, wav)
    jt, jl = jax_make_transcribe_fn(jarch, JaxDecodeConfig(**cfg),
                                    use_pallas_mel=True)(jparams, jnp.asarray(wav))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
