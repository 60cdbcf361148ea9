"""The attention kernels at any head dim from 1 to 256, on the CPU: what
each wrapper's card path hands the kernels at widths that are not whole
bodies (16, 32, 64, 128 are), the plain versions against the JAX
functions at those widths, and the kernels' declared costs against the
`pl.CostEstimate`s of the JAX package's Pallas kernels.

The card paths (`_launch_*`) run on CPU tensors with the kernel library
replaced by `test_torch_head_dims.FakeLib`, which records every launcher's
arguments and marks row `pos` of the caches an update is handed. Holds: the
head dim and its capacity (the smallest of 16, 32, 64, 128, 256 that holds
it) handed to the launchers; no cache padded or copied to reach a capacity
(the caller's pointers are passed, and the update's mark lands in rows of dh
elements); the encoder attention's zero-padded copy made exactly where the
strides need it (a stride not a multiple of 8 elements). The JAX side runs
its Pallas kernels in interpret mode; f32 outputs within 1e-5 (the sums are
ordered otherwise), codes, scales and caches equal."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu.audio import mel_pallas as jax_mel
from openai_whisper_compression_tpu.models import whisper as jax_whisper
from openai_whisper_compression_tpu.ops import attention as jax_att
from openai_whisper_compression_tpu.ops import cross_attention as jax_ca
from openai_whisper_compression_tpu.ops import quant_matmul as jax_qm
from openai_whisper_compression_tpu.ops import self_attention_step as jax_sas
from openai_whisper_compression_tpu_torch.audio import mel_kernel
from openai_whisper_compression_tpu_torch.models.whisper import split_heads
from openai_whisper_compression_tpu_torch.ops import attention as att
from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
from openai_whisper_compression_tpu_torch.ops import kernels
from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas
from openai_whisper_compression_tpu_torch.utils import profiling
from test_torch_head_dims import FakeLib

torch.set_num_threads(2)

WIDTHS = [1, 8, 24, 36, 48, 80, 96, 100, 160, 200, 256]
KINDS_AT = [(dh, kind) for dh in WIDTHS for kind in ("fp", "int8", "int4")
            if kind != "int4" or dh % 2 == 0]   # packed int4 holds dh / 2 rows


def cap_of(dh):
    return next(c for c in (16, 32, 64, 128, 256) if c >= dh)


class PadReader(FakeLib):
    """FakeLib that also reads, during the encoder attention's launch, row 0
    of the k it is handed: (dh columns, the capacity's columns past them)."""

    def __getattr__(self, name):
        launch = super().__getattr__(name)
        if name != "owc_encoder_attention":
            return launch

        def read(*args):
            dh, cap = args[7], args[8]
            row = ctypes.string_at(args[1], cap * 2)
            self.k_row0 = (row[: 2 * dh], row[2 * dh:])
            return launch(*args)
        return read


@pytest.fixture
def lib(monkeypatch):
    fake = PadReader()
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return fake


# --------------------------------------------------------------- card paths

def test_capacity_of_every_width():
    assert [kernels.head_dim_capacity(d) for d in range(1, 257)] == [
        cap_of(d) for d in range(1, 257)]
    assert kernels.CAPACITIES == (16, 32, 64, 128, 256) and kernels.MAX_HEAD_DIM == 256


@pytest.mark.parametrize("dh", WIDTHS)
def test_transpose_quant_kv_hands_dh_and_capacity(lib, dh):
    h = 3
    x = torch.randn(2, 130, h * dh, dtype=torch.bfloat16)
    q, sc = ca._launch_transpose_quant_kv(x, h)
    (args,) = lib.of("owc_transpose_quant_kv")
    assert args[0] == x.data_ptr()   # contiguous and aligned: read in place
    assert args[-3:-1] == (dh, cap_of(dh)) and args[3:7] == (2, 130, h, 256)
    assert q.shape == (2 * h, dh, 256) and sc.shape == (2 * h, 1, 256)


@pytest.mark.parametrize("dh,kind", KINDS_AT)
def test_cross_attention_hands_dh_and_capacity(lib, dh, kind):
    bh, s_pad, s_valid = 24, 256, 200
    rows = dh // 2 if kind == "int4" else dh
    if kind == "fp":
        k, v = torch.randn(2, bh, dh, s_pad)
        ks = vs = None
    else:
        k, v = torch.randint(-127, 128, (2, bh, rows, s_pad), dtype=torch.int8)
        ks, vs = torch.rand(2, bh, 1, s_pad)
    q = torch.randn(bh, 3, dh)
    ca._launch_decode_cross_attention_grouped(q, k, v, ks, vs, s_valid)
    args = lib.of("owc_cross_attention_grouped")[-1]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())   # no copy
    assert args[-3:-1] == (dh, cap_of(dh)) and args[8] == 3 * dh   # row stride
    assert args[-5] == {"fp": 0, "int8": 1, "int4": 2}[kind]
    q1 = torch.randn(bh, dh)
    ca._launch_decode_cross_attention(q1, k, v, ks, vs, s_valid)
    args = lib.of("owc_cross_attention")[-1]
    assert args[:3] == (q1.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[-3:-1] == (dh, cap_of(dh))


@pytest.mark.parametrize("dh", [1, 37, 255])
def test_packed_int4_needs_an_even_head_dim(lib, dh):
    bh = 16
    k = torch.zeros(bh, dh // 2, 128, dtype=torch.int8)
    s = torch.ones(bh, 1, 128)
    with pytest.raises(ValueError, match="even head dim"):
        ca._launch_decode_cross_attention_grouped(torch.zeros(bh, 1, dh), k, k, s, s)
    assert not lib.calls


@pytest.mark.parametrize("dh", WIDTHS)
def test_encoder_attention_pads_only_where_the_strides_need_it(lib, dh):
    """The fused projection's views are read in place where every stride is
    a multiple of 8 elements (dh % 8 == 0 here); otherwise each of q, k and
    v is copied once into a (B, H, T, capacity) buffer whose columns past dh
    are zero. Contiguous (B, H, T, dh) inputs likewise. The output is written
    for dh columns in (B, T, H, dh) memory; the scale is dh ** -0.5."""
    b, h, t = 2, 3, 300
    cap = cap_of(dh)
    fused = torch.randn(b, t, 3 * h * dh).bfloat16()
    q, k, v = (split_heads(fused[..., i * h * dh: (i + 1) * h * dh], h) for i in range(3))
    for inputs in ((q, k, v), tuple(x.contiguous() for x in (q, k, v))):
        before = att.encoder_attention.pad_copies
        out = att._launch_encoder_attention(*inputs)
        args = lib.of("owc_encoder_attention")[-1]
        copied = att.encoder_attention.pad_copies - before
        assert args[7:9] == (dh, cap) and args[9] == pytest.approx(dh ** -0.5)
        strides = list(args[10][:12])
        if dh % 8 == 0:
            assert copied == 0 and args[:3] == tuple(x.data_ptr() for x in inputs)
        else:
            assert copied == 3 and args[1] != inputs[1].data_ptr()
            assert strides[3:6] == [h * t * cap, t * cap, cap]   # k's copy
            row0 = inputs[1][0, 0, 0].contiguous().view(torch.int16)
            assert lib.k_row0[0] == row0.numpy().tobytes()
            assert set(lib.k_row0[1]) <= {0}   # the capacity's columns past dh
        assert all(s % 8 == 0 for s in strides[:9])
        assert out.shape == (b, h, t, dh) and out.transpose(1, 2).is_contiguous()
        assert strides[9:] == [t * h * dh, dh, h * dh]


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dh", WIDTHS)
def test_self_attention_never_copies_a_cache(lib, dh, int8):
    """Contiguous caches of rows of dh elements are handed to the kernels as
    they are, at every width: the update's mark lands in row pos of rows dh
    elements long, and nothing else of them changes."""
    bh, s, pos = 6, 40, 33
    q, kn, vn = torch.randn(3, bh, dh)
    if int8:
        caches = [torch.zeros(bh, s, dh, dtype=torch.int8) for _ in range(2)]
        caches += [torch.zeros(bh, s) for _ in range(2)]
        fn, name = sas._launch_decode_self_attention_update_int8, "owc_self_attention_update_int8"
    else:
        caches = [torch.zeros(bh, s, dh) for _ in range(2)]
        fn, name = sas._launch_decode_self_attention_update, "owc_self_attention_update"
    fn(q, kn, vn, *caches, pos)
    args = lib.of(name)[-1]
    assert args[3:5] == (caches[0].data_ptr(), caches[1].data_ptr())
    assert args[-3:-1] == (dh, cap_of(dh)) and args[-6:-4] == (s, pos)
    for c in caches:
        assert bool((c[:, pos] != 0).all())
        assert not bool(c[:, :pos].any()) and not bool(c[:, pos + 1:].any())
    scales = {"k_scale": caches[2], "v_scale": caches[3]} if int8 else {}
    sas._launch_decode_self_attention(q, caches[0], caches[1], pos, **scales)
    args = lib.of("owc_self_attention_int8" if int8 else "owc_self_attention")[-1]
    assert args[1:3] == (caches[0].data_ptr(), caches[1].data_ptr())
    assert args[-3:-1] == (dh, cap_of(dh))


# ---------------------------------------------------- plain versions vs JAX

def _kv_np(kind, bh, dh, sp, rng):
    """(k_t, v_t, k_scale, v_scale) as numpy: f32 K/V, or int8 / split-half
    int4 quantized by the jitted JAX package."""
    if kind == "fp":
        k, v = rng.standard_normal((2, bh, dh, sp)).astype(np.float32)
        return k, v, None, None
    quant = jax_whisper._quant_kv4_t if kind == "int4" else jax_whisper._quant_kv8_t
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((bh, dh, sp)), jnp.float32)
        out.append(tuple(np.asarray(a) for a in jax.jit(quant)(x)))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dh", WIDTHS)
def test_transpose_quant_kv_plain_matches_jax(dh):
    h = 3
    x = np.random.default_rng(dh).standard_normal((2, 130, h * dh)).astype(np.float32)
    jq, js = jax_ca.transpose_quant_kv(jnp.asarray(x), h)
    q, s = ca.transpose_quant_kv(torch.from_numpy(x), h)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dh", WIDTHS)
def test_encoder_attention_plain_matches_jax(dh):
    rng = np.random.default_rng(dh)
    q, k, v = rng.standard_normal((3, 1, 2, 70, dh)).astype(np.float32)
    want = jax_att.encoder_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = att.encoder_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dh,kind", KINDS_AT)
def test_cross_attention_plain_matches_jax(dh, kind):
    """The grouped (3 slots) and the one-query plain versions against the
    Pallas kernels in interpret mode, s_valid 100 of 128."""
    rng = np.random.default_rng(dh + len(kind))
    bh, s_valid = 16, 100
    kv = _kv_np(kind, bh, dh, 128, rng)
    q = (rng.standard_normal((bh, 3, dh)) * dh ** -0.5).astype(np.float32)
    jkv = [None if a is None else jnp.asarray(a) for a in kv]
    want = jax_ca.decode_cross_attention_grouped(jnp.asarray(q), *jkv, s_valid=s_valid)
    got = ca.decode_cross_attention_grouped(torch.from_numpy(q), *map(_t, kv), s_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    want1 = jax_ca.decode_cross_attention(jnp.asarray(q[:, 0]), *jkv, s_valid=s_valid)
    got1 = ca.decode_cross_attention(torch.from_numpy(q[:, 0].copy()), *map(_t, kv),
                                     s_valid)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dh", WIDTHS)
def test_self_attention_plain_matches_jax(dh, int8):
    """Both updates (with a mixed `start`) and the read-only attention: the
    written caches and scales equal JAX's, the outputs within 1e-5."""
    rng = np.random.default_rng(dh + 7 * int8)
    bh, s, pos = 4, 16, 9
    q = (rng.standard_normal((bh, dh)) * dh ** -0.5).astype(np.float32)
    kn, vn = (rng.standard_normal((2, bh, dh)) * 2).astype(np.float32)
    start = np.array([0, 3, 9, 1][:bh], np.int32)
    if int8:
        kc, vc = rng.integers(-127, 128, (2, bh, s, dh)).astype(np.int8)
        ks, vs = rng.uniform(0.005, 0.03, (2, bh, s)).astype(np.float32)
        want = jax_sas.decode_self_attention_update_int8(
            *map(jnp.asarray, (q, kn, vn, kc, vc, ks, vs)), jnp.asarray(pos),
            start=jnp.asarray(start))
        bufs = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
        got = sas.decode_self_attention_update_int8(
            *map(torch.from_numpy, (q, kn, vn)), *bufs, pos, start=torch.from_numpy(start))
        scales = {"k_scale": bufs[2], "v_scale": bufs[3]}
    else:
        kc, vc = rng.standard_normal((2, bh, s, dh)).astype(np.float32)
        want = jax_sas.decode_self_attention_update(
            *map(jnp.asarray, (q, kn, vn, kc, vc)), jnp.asarray(pos),
            start=jnp.asarray(start))
        bufs = [torch.from_numpy(a.copy()) for a in (kc, vc)]
        got = sas.decode_self_attention_update(
            *map(torch.from_numpy, (q, kn, vn)), *bufs, pos, start=torch.from_numpy(start))
        scales = {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    # JAX returns the int8 cache's codes and scales as (k, k_scale, v, v_scale)
    for buf, w in zip([bufs[0], bufs[2], bufs[1], bufs[3]] if int8 else bufs, want[1:]):
        np.testing.assert_array_equal(buf.numpy(), np.asarray(w))
    jscales = {k: jnp.asarray(v.numpy()) for k, v in scales.items()}
    want_ro = jax_sas.decode_self_attention(
        jnp.asarray(q), jnp.asarray(bufs[0].numpy()), jnp.asarray(bufs[1].numpy()),
        jnp.asarray(pos), start=jnp.asarray(start), **jscales)
    got_ro = sas.decode_self_attention(torch.from_numpy(q), bufs[0], bufs[1], pos,
                                       start=torch.from_numpy(start), **scales)
    np.testing.assert_allclose(got_ro.numpy(), np.asarray(want_ro), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the costs

def _pallas_costs(fn, *args, **kw):
    """The cost_estimate of every pallas_call in fn's jaxpr (sub-jaxprs too)."""
    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pallas_call":
                yield e.params["cost_estimate"]
            for v in e.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    yield from walk(sub if hasattr(sub, "eqns") else sub.jaxpr)
    return list(walk(jax.make_jaxpr(lambda *a: fn(*a, **kw))(*args).jaxpr))


def _as_cost(est):
    return kernels.cost(est.flops, est.bytes_accessed, est.transcendentals)


def _z(shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def _case(name, shape):
    """(JAX function, its arguments and keywords, the port's cost) of one
    kernel at one shape."""
    bf = jnp.bfloat16
    if name == "log_mel":
        b, t = shape
        wav = _z((b, t))
        return jax_mel.log_mel_pallas, (wav,), {}, mel_kernel.log_mel_cost(b, 1 + t // 160)
    if name in ("int8_matmul", "w8a8_matmul"):
        m, k, n = shape
        args = (_z((m, k), bf), _z((k, n), jnp.int8), _z((1, n)))
        if name == "int8_matmul":
            return jax_qm.int8_matmul_pallas, args, {}, qm.int8_matmul_cost(m, n, k)
        return jax_qm.w8a8_matmul_pallas, args, {}, qm.w8a8_matmul_cost(m, n, k)
    if name == "int4_matmul":
        m, k, n = shape
        return (jax_qm.int4_matmul_pallas, (_z((m, k), bf), _z((k // 2, n), jnp.int8),
                                            _z((1, n))), {"k": k}, qm.int4_matmul_cost(m, n, k))
    if name == "nf4_matmul":
        m, k, n, g = shape
        return (jax_qm.nf4_matmul_pallas, (_z((m, k), bf), _z((k // 2, n), jnp.int8),
                                           _z((k // g, n))), {"kind": "nf4", "k": k, "g": g},
                qm.nf4_matmul_cost(m, n, k, g))
    if name == "group_asym_matmul":
        m, k, n, g, packed = shape
        rows = k // 2 if packed else k
        w = _z((rows, n), jnp.int8 if packed else jnp.uint8)
        return (jax_qm.group_asym_matmul_pallas, (_z((m, k), bf), w, _z((k // g, n)),
                                                  _z((k // g, n))), {"k": k, "g": g},
                qm.group_asym_matmul_cost(m, n, k, g, rows))
    if name == "transpose_quant_kv":
        b, s, h, dh = shape
        return (jax_ca.transpose_quant_kv, (_z((b, s, h * dh), bf),), {"h": h},
                ca.transpose_quant_kv_cost(b, s, h, dh, 2))
    if name == "encoder_attention":
        b, h, t, dh = shape
        return (jax_att.encoder_attention_pallas, (_z((b, h, t, dh), bf),) * 3, {},
                att.encoder_attention_cost(b, h, t, dh, 2))
    if name in ("cross_grouped", "cross_one_query"):
        bh, kq, dh, sp, kind = shape
        rows = dh // 2 if kind == "int4" else dh
        kv_t = bf if kind == "fp" else jnp.int8
        kv = [_z((bh, rows, sp), kv_t), _z((bh, rows, sp), kv_t)]
        scales = [None, None] if kind == "fp" else [_z((bh, 1, sp)), _z((bh, 1, sp))]
        item = 2 if kind == "fp" else 1
        if name == "cross_grouped":
            return (jax_ca.decode_cross_attention_grouped,
                    (_z((bh, kq, dh), bf), kv[0], kv[1], *scales), {"s_valid": sp - 20},
                    ca.decode_cross_attention_grouped_cost(bh, kq, dh, sp, item))
        return (jax_ca.decode_cross_attention, (_z((bh, dh), bf), kv[0], kv[1], *scales),
                {"s_valid": sp - 20},
                ca.decode_cross_attention_cost(bh, dh, sp, rows, item, kind))
    bh, s, dh = shape
    q = _z((bh, dh), bf)
    if name == "self_update":
        return (jax_sas.decode_self_attention_update,
                (q, q, q, _z((bh, s, dh), bf), _z((bh, s, dh), bf), jnp.asarray(3)), {},
                sas.self_attention_cost(bh, s, dh, 2))
    if name == "self_update_int8":
        c = _z((bh, s, dh), jnp.int8)
        return (jax_sas.decode_self_attention_update_int8,
                (q, q, q, c, c, _z((bh, s)), _z((bh, s)), jnp.asarray(3)), {},
                sas.self_attention_cost(bh, s, dh, 1))
    return (jax_sas.decode_self_attention,
            (q, _z((bh, s, dh), bf), _z((bh, s, dh), bf), jnp.asarray(3)), {},
            sas.self_attention_cost(bh, s, dh, 2))


# each of the 13 Pallas kernels at two shapes, one of them ragged (a head
# dim that is no whole body, or an N or K off the blocks)
COST_CASES = [
    ("log_mel", (2, 480000)), ("log_mel", (3, 160000)),
    ("int8_matmul", (96, 768, 2304)), ("int8_matmul", (33, 922, 500)),
    ("int4_matmul", (64, 1024, 3072)), ("int4_matmul", (5, 1000, 700)),
    ("nf4_matmul", (32, 768, 2304, 64)), ("nf4_matmul", (7, 512, 900, 64)),
    ("group_asym_matmul", (32, 768, 768, 64, True)),
    ("group_asym_matmul", (9, 768, 650, 128, False)),
    ("w8a8_matmul", (96, 768, 2304)), ("w8a8_matmul", (300, 922, 770)),
    ("transpose_quant_kv", (2, 1500, 12, 64)), ("transpose_quant_kv", (3, 130, 7, 100)),
    ("encoder_attention", (2, 2, 256, 64)), ("encoder_attention", (1, 3, 300, 36)),
    ("cross_grouped", (32, 1, 64, 1536, "int8")), ("cross_grouped", (24, 3, 96, 256, "int4")),
    ("cross_one_query", (12, 1, 64, 1536, "fp")), ("cross_one_query", (20, 1, 100, 256, "int8")),
    ("self_update", (8, 64, 64)), ("self_update", (6, 40, 36)),
    ("self_update_int8", (8, 64, 64)), ("self_update_int8", (6, 40, 200)),
    ("self_attention", (8, 64, 64)), ("self_attention", (6, 40, 24)),
]


@pytest.mark.parametrize("name,shape", COST_CASES, ids=[f"{n}-{i % 2}" for i, (n, _) in
                                                        enumerate(COST_CASES)])
def test_cost_functions_equal_the_pallas_cost_estimates(name, shape):
    fn, args, kw, cost = _case(name, shape)
    (est,) = _pallas_costs(fn, *args, **kw)
    assert cost == _as_cost(est)


def test_the_costs_cover_all_13_kernels():
    kernels_of = {"log_mel", "int8_matmul", "int4_matmul", "nf4_matmul",
                  "group_asym_matmul", "w8a8_matmul", "transpose_quant_kv",
                  "encoder_attention", "cross_grouped", "cross_one_query", "self_update",
                  "self_update_int8", "self_attention"}
    assert {n for n, _ in COST_CASES} == kernels_of
    assert all(sum(n == k for n, _ in COST_CASES) == 2 for k in kernels_of)


@pytest.mark.parametrize("dh", [64, 100])
def test_cost_analysis_counts_a_launch(lib, dh):
    """`cost_analysis` of one `_launch_*` call (through the recording
    library) reports the flops, bytes and transcendentals the JAX kernel
    declares at the same shapes; with the tensors read and written by the
    call counted apart (its arguments and outputs) they add to it."""
    bh, kq, sp = 24, 3, 256
    q = torch.randn(bh, kq, dh)
    k, v = torch.randint(-127, 128, (2, bh, dh, sp), dtype=torch.int8)
    ks, vs = torch.rand(2, bh, 1, sp)
    def launch_only():   # reads and writes no tensor of its own
        ca._launch_decode_cross_attention_grouped(q, k, v, ks, vs, 200)

    costs = profiling.cost_analysis(launch_only)
    (est,) = _pallas_costs(jax_ca.decode_cross_attention_grouped,
                           _z((bh, kq, dh)), _z((bh, dh, sp), jnp.int8),
                           _z((bh, dh, sp), jnp.int8), _z((bh, 1, sp)), _z((bh, 1, sp)),
                           s_valid=200)
    assert costs == _as_cost(est)
    with_io = profiling.cost_analysis(ca._launch_decode_cross_attention_grouped,
                                      q, k, v, ks, vs, 200)
    io = sum(t.numel() * t.element_size() for t in (q, k, v, ks, vs)) + q.numel() * 4
    assert with_io["flops"] == est.flops and with_io["transcendentals"] == est.transcendentals
    assert with_io["bytes accessed"] == est.bytes_accessed + io


def test_cost_analysis_counts_bmm_with_an_f32_output():
    """`aten.bmm.dtype`, the bf16 product with an f32 output that
    `ops.attention.matmul_f32` takes on the card, counts as `aten.bmm` does
    (meta tensors: the CPU build has no kernel for that overload)."""
    a = torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 4, 5, dtype=torch.bfloat16, device="meta")

    def products():
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.bmm(a, b)

    assert profiling.cost_analysis(products)["flops"] == 2 * (2 * 2 * 3 * 4 * 5)


def test_flops_per_second_counts_kernel_flops(lib):
    """A call that launched a kernel reports a rate (no longer None): its
    flops are what the kernel declares, here a matmul wrapper's `_run`."""
    x = torch.randn(96, 768).bfloat16()
    cost = qm.int8_matmul_cost(96, 2304, 768)

    def launch():
        qm._run("int8_matmul", "owc_int8_matmul", x, 2304, qm._ktiles(768), (0, 0, 0), (),
                cost)

    perf = profiling.flops_per_second(launch, iters=2)
    assert perf["model_flops"] == cost["flops"] == 2 * 96 * 2304 * 768
    assert perf["achieved_tflops"] is not None and perf["achieved_tflops"] > 0
    assert lib.of("owc_int8_matmul")


# ------------------------------------------------------------ the test models

def _variant(dh):
    """test2l cut into 4 heads of 36 (d_model 144) or 2 of 96 (192)."""
    from openai_whisper_compression_tpu.config import ARCHS as JAX_ARCHS
    from openai_whisper_compression_tpu_torch.config import ARCHS

    heads = {36: 4, 96: 2}[dh]
    kw = dict(name=f"test2l-dh{dh}", d_model=heads * dh, encoder_heads=heads,
              decoder_heads=heads, ffn_dim=4 * heads * dh)
    return JAX_ARCHS["test2l"].replace(**kw), ARCHS["test2l"].replace(**kw)


@pytest.fixture(scope="module")
def variant_params():
    from openai_whisper_compression_tpu.models import params as JP
    from openai_whisper_compression_tpu_torch.models.params import from_numpy

    out = {}
    for dh in (36, 96):
        jarch, arch = _variant(dh)
        jp = JP.init_params_jit(jarch, jax.random.PRNGKey(dh), std=0.5)
        out[dh] = (jarch, arch, jp, from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


DECODES = {"fp": {}, "int8": {"kv_int8": True, "cross_kv_int8": True},
           "int4": {"kv_int8": True, "cross_kv_int4": True}}


@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
@pytest.mark.parametrize("kv", DECODES)
@pytest.mark.parametrize("dh", [36, 96])
def test_test_model_variants_decode_like_jax(variant_params, dh, kv, beam):
    """`make_transcribe_fn` on the f32 test2l variants (head dims 36 and 96)
    over fp, int8 and int4 caches, greedy and beam 2, at batch 3: the same
    tokens and lengths as the jitted JAX transcription function."""
    from openai_whisper_compression_tpu.config import DecodeConfig as JaxDecodeConfig
    from openai_whisper_compression_tpu.evaluation.harness import (
        make_transcribe_fn as jax_make_transcribe_fn)
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn, samples_for_arch)

    jarch, arch, jp, tp = variant_params[dh]
    wav = (np.random.default_rng(dh + beam).standard_normal((3, samples_for_arch(arch)))
           * 0.3).astype(np.float32)
    cfg = dict(max_new_tokens=6, beam_size=beam, **DECODES[kv])
    jt, jl = jax_make_transcribe_fn(jarch, JaxDecodeConfig(**cfg))(jp, jnp.asarray(wav))
    tt, tl = make_transcribe_fn(arch, DecodeConfig(**cfg), device="cpu")(tp, wav)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
