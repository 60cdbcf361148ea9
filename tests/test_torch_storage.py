"""The port's storage formats (`storage/formats.py`, `storage/checkpoint.py`,
`models/params.py::disk_size_in_mb`, `runtime_native.py`'s sparse codec)
against the JAX package on `test2l` (at width 128 for `hqq_int8`, whose
128-row groups test2l's 64 does not hold), the same trees on both sides
(`init_params_jit`, carried over by `from_numpy`).

- The cases of `tests/test_storage.py` for each format: dense, pruned,
  quantized and structurally pruned trees through `verify_roundtrip`.
- The files are the JAX package's: a file written by either package loads
  in the other with every leaf (and QTensor field) equal bit for bit and
  an equal manifest, for npz, gzip and sparse-zip, for the dense tree, a
  90%-pruned one and every `REGISTRY` name (bf16 / f16 trees, fp8 weights
  and the static configurations with an `act_scale` included).
- `sparse_encode` / `sparse_decode` equal to JAX's, native and numpy.
- The npz checkpoint, the refusal of an Orbax directory, and
  `disk_size_in_mb` equal to JAX's (raw and compressed: deflate of equal
  arrays under equal names gives equal sizes; zip timestamps differ, so
  files are compared through their contents, never their bytes).

Every tolerance here is zero."""

import dataclasses
import json
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu import runtime_native as jax_rn
from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
from openai_whisper_compression_tpu.models import params as JP
from openai_whisper_compression_tpu.ops.qtensor import QTensor as JaxQTensor
from openai_whisper_compression_tpu.prune import magnitude as jax_mag
from openai_whisper_compression_tpu.quant import api as jax_api
from openai_whisper_compression_tpu.storage import checkpoint as jax_ckpt
from openai_whisper_compression_tpu.storage import formats as jax_formats
from openai_whisper_compression_tpu_torch import runtime_native as rn
from openai_whisper_compression_tpu_torch.config import ARCHS
from openai_whisper_compression_tpu_torch.models import params as P
from openai_whisper_compression_tpu_torch.models.whisper import forward
from openai_whisper_compression_tpu_torch.ops.qtensor import QTensor
from openai_whisper_compression_tpu_torch.prune import magnitude, structured
from openai_whisper_compression_tpu_torch.quant import api
from openai_whisper_compression_tpu_torch.storage import checkpoint, formats

DEV = "cpu"  # the port's entry points default to the card

torch.set_num_threads(2)

J_ARCH, ARCH = JAX_ARCHS["test2l"], ARCHS["test2l"]
# d_model 128 so that every projection holds whole 128-row HQQ int8 groups
WIDE = {"hqq_int8"}
J_WIDE = J_ARCH.replace(d_model=128, ffn_dim=256)
FMTS = ["sparse_zip", "gzip", "npz"]
_QFIELDS = ("data", "scale", "zero", "scale2", "offset2", "act_scale")


def _port(jtree):
    return P.from_numpy(jax.tree.map(np.asarray, jtree), device=DEV)


@pytest.fixture(scope="module")
def trees():
    """(JAX tree, port tree) of test2l, seed 0, f32."""
    jp = JP.init_params_jit(J_ARCH, jax.random.PRNGKey(0))
    return jp, _port(jp)


def _bytes(x) -> np.ndarray:
    """The bytes of a JAX or numpy array, or of a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def assert_same_tree(got, ref):
    """Trees of either package equal bit for bit: the same leaf names and,
    for every leaf (every QTensor field and attribute), the same dtype,
    shape and bytes."""
    def leaves(t):
        return dict(P.named_leaves(t)) if _is_port(t) else dict(JP.named_leaves(t))

    g, r = leaves(got), leaves(ref)
    assert sorted(g) == sorted(r)
    for n, a in g.items():
        b = r[n]
        if isinstance(a, (QTensor, JaxQTensor)):
            assert isinstance(b, (QTensor, JaxQTensor)), n
            assert (a.kind, int(a.bits), tuple(a.shape), int(a.block_size), a.act) == (
                b.kind, int(b.bits), tuple(b.shape), int(b.block_size), b.act), n
            pairs = [(f"{n}::{f}", getattr(a, f), getattr(b, f)) for f in _QFIELDS]
        else:
            pairs = [(n, a, b)]
        for what, x, y in pairs:
            assert (x is None) == (y is None), what
            if x is None:
                continue
            assert _dtype_name(x) == _dtype_name(y), what
            assert tuple(x.shape) == tuple(np.shape(y)), what
            np.testing.assert_array_equal(_bytes(x), _bytes(y), err_msg=what)


def _is_port(tree) -> bool:
    leaf = P.named_leaves(tree)[0][1]
    return isinstance(leaf, (torch.Tensor, QTensor))


def _with_act_scales(jtree):
    """Each statically quantized linear given a distinct frozen activation
    scale (0-dim f32), as `calibrate_static` leaves it."""
    k = [0]

    def put(x):
        if isinstance(x, JaxQTensor) and x.act in ("static_int8", "static_fp8"):
            k[0] += 1
            return dataclasses.replace(x, act_scale=jnp.asarray(0.01 * k[0], jnp.float32))
        return x

    return jax.tree.map(put, jtree, is_leaf=lambda x: isinstance(x, JaxQTensor))


def _manifest(path: str, fmt: str) -> dict:
    if fmt == "npz":
        with np.load(path, allow_pickle=False) as d:
            return json.loads(str(d["__manifest__"]))
    if fmt == "gzip":
        import gzip
        import pickle

        with gzip.open(path, "rb") as f:
            blob = pickle.loads(f.read())
        assert all(isinstance(a, np.ndarray) for a in blob["arrays"].values())
        return blob["manifest"]
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("manifest.json"))


def _contiguous_on(tree, device) -> bool:
    return all((f.is_contiguous() and f.device.type == device)
               for _, leaf in P.named_leaves(tree)
               for f in ([getattr(leaf, k) for k in _QFIELDS if getattr(leaf, k) is not None]
                         if isinstance(leaf, QTensor) else [leaf]))


# ---------------------------------------------------------------- round trips

@pytest.mark.parametrize("fmt", FMTS)
def test_roundtrip_dense(trees, tmp_path, fmt):
    _, tp = trees
    res = formats.verify_roundtrip(tp, str(tmp_path / f"m.{fmt}"), fmt)
    assert res["ok"], res["mismatches"][:5]
    loaded = formats.FORMATS[fmt][1](str(tmp_path / f"m.{fmt}"), device=DEV)
    assert isinstance(loaded["encoder"]["layers"], list)
    assert _contiguous_on(loaded, "cpu")
    assert_same_tree(loaded, tp)


def test_roundtrip_pruned_and_compression_win(trees, tmp_path):
    """A 90%-pruned tree: exact sparsity after the sparse zip, the sparse
    branch taken, the file much smaller than the dense tree's; the stats
    equal JAX's on the same tree."""
    jp, tp = trees
    pruned = magnitude.prune_global_l1(tp, 0.9)
    dense_res = formats.verify_roundtrip(tp, str(tmp_path / "d.zip"), "sparse_zip")
    sparse_res = formats.verify_roundtrip(pruned, str(tmp_path / "s.zip"), "sparse_zip")
    assert sparse_res["ok"] and sparse_res["sparse_tensors"] > 0
    assert sparse_res["file_mb"] < 0.65 * dense_res["file_mb"]
    loaded = formats.load_sparse_zip(str(tmp_path / "s.zip"), device=DEV)
    assert (magnitude.sparsity_report(loaded, magnitude.linear_weights)["overall_sparsity"]
            == magnitude.sparsity_report(pruned, magnitude.linear_weights)["overall_sparsity"])
    jres = jax_formats.save_sparse_zip(jax_mag.prune_global_l1(jp, 0.9),
                                       str(tmp_path / "j.zip"))
    assert ({k: sparse_res[k] for k in ("sparse_tensors", "dense_tensors")}
            == {k: jres[k] for k in ("sparse_tensors", "dense_tensors")})


@pytest.mark.parametrize("fmt", FMTS)
def test_roundtrip_quantized(trees, tmp_path, fmt):
    """The quantized kinds of `tests/test_storage.py` round-trip, and a
    reloaded int8 tree gives the in-memory tree's logits bit for bit."""
    _, tp = trees
    for method in ("int8", "int4", "nf4_dq", "hqq_int4", "fp8"):
        qp = api.quantize_params(tp, method)
        res = formats.verify_roundtrip(qp, str(tmp_path / f"q_{method}.{fmt}"), fmt)
        assert res["ok"], (method, res["mismatches"][:5])
    qp = api.quantize_params(tp, "int8")
    save, load = formats.FORMATS[fmt]
    save(qp, str(tmp_path / f"q.{fmt}"))
    loaded = load(str(tmp_path / f"q.{fmt}"), device=DEV)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, ARCH.num_mel_bins, 64)).astype(np.float32))
    toks = torch.tensor([[998, 1, 2]])
    assert torch.equal(forward(qp, ARCH, mel, toks), forward(loaded, ARCH, mel, toks))


@pytest.mark.parametrize("fmt", FMTS)
def test_roundtrip_structurally_pruned(trees, tmp_path, fmt):
    """Physically shrunk trees (heads dropped, a layer removed) round-trip,
    with the shorter layer list and the narrower widths."""
    _, tp = trees
    pruned = structured.drop_layers(structured.prune_heads_by_l1(tp, ARCH, 0.5),
                                    "decoder", [1])
    res = formats.verify_roundtrip(pruned, str(tmp_path / f"sp.{fmt}"), fmt)
    assert res["ok"]
    loaded = formats.FORMATS[fmt][1](str(tmp_path / f"sp.{fmt}"), device=DEV)
    assert len(loaded["decoder"]["layers"]) == ARCH.decoder_layers - 1
    assert P.get_leaf(loaded, "encoder.layers.0.attn.q.w").shape[1] == 2 * ARCH.head_dim


def test_verify_roundtrip_names_a_mismatch(trees, tmp_path, monkeypatch):
    """A reload that differs in one leaf is reported by name."""
    _, tp = trees
    real = formats.FORMATS["npz"][1]

    def flipped(path, device):
        t = real(path, device=device)
        t["decoder"]["ln"]["g"] = t["decoder"]["ln"]["g"] + 1.0
        return t

    monkeypatch.setitem(formats.FORMATS, "npz", (formats.save_npz, flipped))
    res = formats.verify_roundtrip(tp, str(tmp_path / "m.npz"), "npz")
    assert not res["ok"] and res["mismatches"] == ["decoder.ln.g"]


# ------------------------------------------------------- files of either side

def _jax_cases():
    return ["dense", "pruned90"] + list(jax_api.REGISTRY)


@pytest.fixture(scope="module")
def case_trees(trees):
    jp, _ = trees
    cache: dict = {}

    def get(case):
        if case not in cache:
            if case == "dense":
                j = jp
            elif case == "pruned90":
                j = jax_mag.prune_global_l1(jp, 0.9)
            else:
                base = JP.init_params_jit(J_WIDE, jax.random.PRNGKey(0)) if case in WIDE else jp
                j = _with_act_scales(jax_api.apply_named_config(base, case))
            cache[case] = (j, _port(j))
        return cache[case]

    return get


@pytest.mark.parametrize("case", _jax_cases())
@pytest.mark.parametrize("fmt", FMTS)
def test_files_load_in_the_other_package(case_trees, tmp_path, fmt, case):
    """JAX's file loads in the port, the port's in JAX, every leaf bit-equal
    to the tree that was saved, and both files carry one manifest."""
    j, t = case_trees(case)
    jsave, jload = jax_formats.FORMATS[fmt]
    save, load = formats.FORMATS[fmt]
    jpath, tpath = str(tmp_path / f"jax.{fmt}"), str(tmp_path / f"port.{fmt}")
    jstats, tstats = jsave(j, jpath), save(t, tpath)
    from_jax = load(jpath, device=DEV)
    assert _contiguous_on(from_jax, "cpu")
    assert_same_tree(from_jax, t)
    assert_same_tree(jload(tpath), j)
    assert _manifest(tpath, fmt) == _manifest(jpath, fmt)
    if fmt == "sparse_zip":
        assert tstats["sparse_tensors"] == jstats["sparse_tensors"]
        with zipfile.ZipFile(jpath) as zj, zipfile.ZipFile(tpath) as zt:
            assert zj.namelist() == zt.namelist()
    if fmt == "npz":   # deflate of equal arrays under equal names
        assert tstats["file_mb"] == jstats["file_mb"]


def test_bf16_and_fp8_storage_layout(case_trees, tmp_path):
    """A bf16 leaf is stored as JAX stores it (a flat uint8 view with
    `viewdtype` and the shape) and an fp8 QTensor field as bytes with its
    `__fp8` flag; numpy dtype names only in the manifest."""
    _, t = case_trees("baseline_bf16")
    formats.save_npz(t, str(tmp_path / "b.npz"))
    m = _manifest(str(tmp_path / "b.npz"), "npz")["leaves"]
    assert m["decoder.embed"] == {"type": "array", "dtype": "uint8",
                                  "viewdtype": "bfloat16",
                                  "shape": [ARCH.vocab_size, ARCH.d_model]}
    _, t = case_trees("static_fp8")
    formats.save_gzip(t, str(tmp_path / "f.gz"))
    m = _manifest(str(tmp_path / "f.gz"), "gzip")["leaves"]
    q = m["decoder.layers.0.fc1.w"]
    assert q["type"] == "qtensor" and q["kind"] == "fp8" and q["fields"]["data__fp8"] is True
    assert all("torch" not in json.dumps(v) for v in m.values())


def test_gzip_of_several_members_loads_in_jax(tmp_path):
    """A pickle above one 16 MiB gzip piece is written as several gzip
    members (compressed on parallel threads); JAX's `load_gzip` and the
    port's read them as one stream."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((3000, 2000)
                                                                  ).astype(np.float32))
    tree = {"encoder": {"w": w, "b": w[0].bfloat16().contiguous()}}
    stats = formats.save_gzip(tree, str(tmp_path / "big.gz"))
    assert stats["raw_mb"] > 16
    with open(tmp_path / "big.gz", "rb") as f:
        assert f.read().count(b"\x1f\x8b\x08\x00\x00\x00\x00\x00") >= 2   # member headers
    assert_same_tree(formats.load_gzip(str(tmp_path / "big.gz"), device=DEV), tree)
    back = jax_formats.load_gzip(str(tmp_path / "big.gz"))
    np.testing.assert_array_equal(np.asarray(back["encoder"]["w"]), w.numpy())


# ------------------------------------------------------------------ the codec

@pytest.fixture(scope="module")
def native_library():
    """A finished native library before either package's loader is first
    asked in this file. The reference's loader runs `make`, which writes the
    library in place, so a loader that starts meanwhile in another process
    can open a half-written file and remember the failure for good. The
    port's locked build (`runtime_native.build`) puts a whole library in
    place; the reference's remembered load is then dropped and retried
    until a build some other process started has finished too."""
    built = rn.build()
    for _ in range(120):
        jax_rn._lib.cache_clear()
        if not built or jax_rn._lib() is not None:
            break
        time.sleep(0.5)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_sparse_codec_matches_jax(monkeypatch, native, native_library):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 53)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0.0
    if not native:
        monkeypatch.setattr(rn, "_lib", lambda: None)
        monkeypatch.setattr(jax_rn, "_lib", lambda: None)
    idx, val = rn.sparse_encode(x)
    jidx, jval = jax_rn.sparse_encode(x)
    assert idx.dtype == np.int64 and val.dtype == np.float32
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(val, jval)
    out = rn.sparse_decode(idx, val, x.shape)
    np.testing.assert_array_equal(out, jax_rn.sparse_decode(jidx, jval, x.shape))
    np.testing.assert_array_equal(out, x)
    assert rn.available() == jax_rn.available()


# ------------------------------------------------- checkpoint and disk size

def test_checkpoint_npz_and_orbax_refusal(trees, tmp_path):
    jp, tp = trees
    p = checkpoint.save(tp, str(tmp_path / "ckpt.npz"))
    assert_same_tree(checkpoint.load(p, device=DEV), tp)
    assert_same_tree(jax_ckpt.load(p), jp)
    # where JAX would write an Orbax directory, the port writes path + ".npz"
    q = checkpoint.save(tp, str(tmp_path / "run1") + "/")
    assert q == str(tmp_path / "run1.npz")
    assert_same_tree(checkpoint.load(q, device=DEV), tp)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.load(str(tmp_path / "orbax_dir"), device=DEV)
    with pytest.raises(ValueError, match="npz"):
        checkpoint.load(str(tmp_path / "run1"), device=DEV)


@pytest.mark.parametrize("case", ["dense", "pruned90", "quanto_int8", "bnb_nf4_double_quant",
                                  "baseline_bf16", "static_fp8_act_fp8"])
def test_disk_size_in_mb_matches_jax(case_trees, case):
    j, t = case_trees(case)
    assert P.disk_size_in_mb(t) == JP.disk_size_in_mb(j)
    assert P.disk_size_in_mb(t, compressed=True) == JP.disk_size_in_mb(j, compressed=True)
