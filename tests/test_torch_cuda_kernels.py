"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes and in the dtypes each takes (chip_smoke.py covers the
whisper-small main-path shapes): mel, int8 matmul, grouped cross-attention
over bf16 / int8 / int4 K/V (1 to 8 slots and longer windows), the
one-query cross-attention over the same three storages, the cross-KV
transpose + int8 quantize, the fp and int8 self-attention cache updates
(with and without `start`), the read-only self-attention, the w8a8 matmul
(dynamic and static) and the encoder attention; the f32 and f16 bodies of
the decode attention kernels and of the matmuls; two runs of one matmul call
bit for bit; the wrappers' refusals; and bf16 attention on the card against a float64 reference with
f32 scores. Marked `cuda`; every test skips where no
CUDA device is present. Needs no jax, so on the GPU machine run it without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from openai_whisper_compression_tpu_torch.audio import features
from openai_whisper_compression_tpu_torch.audio.mel_kernel import log_mel_cuda
from openai_whisper_compression_tpu_torch.models import whisper
from openai_whisper_compression_tpu_torch.ops.attention import (
    encoder_attention, encoder_attention_ref)
from openai_whisper_compression_tpu_torch.ops.cross_attention import (
    decode_cross_attention, decode_cross_attention_grouped,
    decode_cross_attention_grouped_ref, decode_cross_attention_ref,
    transpose_quant_kv, transpose_quant_kv_ref)
from openai_whisper_compression_tpu_torch.ops.qtensor import effective_block_scale
from openai_whisper_compression_tpu_torch.ops.quant_matmul import (
    group_asym_matmul, group_asym_matmul_ref, int4_matmul, int4_matmul_ref,
    int8_matmul, int8_matmul_ref, nf4_matmul, nf4_matmul_ref, w8a8_matmul,
    w8a8_matmul_ref)
from openai_whisper_compression_tpu_torch.ops.self_attention_step import (
    decode_self_attention, decode_self_attention_ref,
    decode_self_attention_update, decode_self_attention_update_int8,
    decode_self_attention_update_int8_ref, decode_self_attention_update_ref)
from openai_whisper_compression_tpu_torch.quant.core import (
    quantize_hqq, quantize_int8, quantize_int_sub8, quantize_nf4)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
# what the matmuls, the cross-KV quantizer and the decode attentions take
FLOATS = [torch.float32, torch.bfloat16, torch.float16]
_IDS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_COUNTER = {torch.float32: "_f32", torch.bfloat16: "", torch.float16: "_f16"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, scale):
    """Of the reference's largest magnitude `scale`: f32 outputs differ by
    sum-order noise (1e-5); bf16 outputs by at most one bf16 step (2**-7),
    f16 outputs by one f16 step (2**-10)."""
    return {torch.float32: 1e-5, torch.bfloat16: 2 ** -7,
            torch.float16: 2 ** -10}[dtype] * scale


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (33, 768, 2304),
                                   (96, 3072, 768), (200, 128, 192)])
def test_int8_matmul(dev, dtype, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m)
    q = quantize_int8(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    before = int8_matmul.launches
    got = int8_matmul(x, q.data, q.scale)
    assert int8_matmul.launches == before + 1
    ref = int8_matmul_ref(x, q.data, q.scale)
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))


# (M, K, N): one decode row and a batch-256 prefill at whisper-medium's
# fc2 (4096 x 1024) and qkv (1024 x 3072), a ragged M, the smallest tile
FOUR_BIT_SHAPES = [(1, 4096, 1024), (256, 4096, 1024), (1, 1024, 3072),
                   (256, 1024, 3072), (37, 256, 64)]


def _check_kernel(fn, ref, counter, x, *args):
    """fn(x, *args) launches once and lies within _tol of ref(x, *args)."""
    wrapper, attr = counter
    before = getattr(wrapper, attr)
    got = fn(x, *args)
    assert getattr(wrapper, attr) == before + 1
    want = ref(x, *args)
    assert got.dtype == x.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(x.dtype, float(want.float().abs().max())))
    return got


def _weight_and_x(dev, dtype, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    w[:, 5] = 0.0   # an all-zero column: the smallest scales the quantizers make
    return w, torch.randn(m, k, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("m,k,n", FOUR_BIT_SHAPES)
def test_int4_matmul(dev, dtype, m, k, n):
    """Column scales of 0 and 1e-12 included (1e-12 is the quantizer's
    floor, for an all-zero column)."""
    w, x = _weight_and_x(dev, dtype, m, k, n, m + k + n)
    q = quantize_int_sub8(w, 4)
    q.scale[:, 0] = 0.0
    assert float(q.scale[0, 5]) == float(torch.tensor(1e-12))
    got = _check_kernel(int4_matmul, int4_matmul_ref, (int4_matmul, "launches"),
                        x, q.data, q.scale)
    assert not got[:, 0].any() and not got[:, 5].any()


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("m,k,n", FOUR_BIT_SHAPES)
@pytest.mark.parametrize("kind,dq,block", [("nf4", False, 64), ("fp4", True, 64),
                                           ("nf4", True, 128)])
def test_nf4_matmul(dev, dtype, m, k, n, kind, dq, block):
    """NF4 and FP4 (its -0.0 and 0.0052 entries), plain and double-quant
    scales folded as `linear` folds them, blocks of 64 and 128, and block
    scales of 0 and 1e-12."""
    w, x = _weight_and_x(dev, dtype, m, k, n, m + k + n + block)
    q = quantize_nf4(w, block_size=block, double_quant=dq, kind=kind)
    scale = effective_block_scale(q).contiguous()
    scale[0, :8] = 0.0
    scale[-1, 8:16] = 1e-12
    _check_kernel(nf4_matmul, nf4_matmul_ref, (nf4_matmul, "launches"),
                  x, q.data, scale, kind, block)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("m,k,n", FOUR_BIT_SHAPES)
@pytest.mark.parametrize("bits,group", [(3, 64), (4, 64), (4, 128), (8, 128)])
def test_group_asym_matmul(dev, dtype, m, k, n, bits, group):
    """HQQ values as split-half nibbles (bits 3, 4) and as uint8 (bits 8),
    groups of 64 and 128, with group scales of 0 and 1e-12; each storage
    counts its own launches."""
    w, x = _weight_and_x(dev, dtype, m, k, n, m + k + n + bits)
    q = quantize_hqq(w, bits=bits, group_size=group)
    q.scale[0, :8] = 0.0
    q.scale[-1, 8:16] = 1e-12
    attr = "launches_u8" if bits == 8 else "launches"
    _check_kernel(group_asym_matmul, group_asym_matmul_ref,
                  (group_asym_matmul, attr), x, q.data, q.scale, q.zero, group)


# every storage trait: (quantizer call, kernel, plain version, counter, args)
def _trait_case(trait, w):
    if trait == "int8":
        q = quantize_int8(w)
        return int8_matmul, int8_matmul_ref, "launches", (q.data, q.scale)
    if trait == "int4":
        q = quantize_int_sub8(w, 4)
        return int4_matmul, int4_matmul_ref, "launches", (q.data, q.scale)
    if trait == "nf4":
        q = quantize_nf4(w, block_size=64, double_quant=True, kind="nf4")
        return nf4_matmul, nf4_matmul_ref, "launches", (
            q.data, effective_block_scale(q).contiguous(), "nf4", 64)
    bits, attr = (4, "launches") if trait == "hqq4" else (8, "launches_u8")
    q = quantize_hqq(w, bits=bits, group_size=128 if bits == 8 else 64)
    return group_asym_matmul, group_asym_matmul_ref, attr, (
        q.data, q.scale, q.zero, q.block_size)


TRAITS = ["int8", "int4", "nf4", "hqq4", "hqq8"]
# K -> N of a decoder linear with that depth (whisper-small qkv and fc2,
# whisper-medium o and fc2)
DEPTHS = {768: 2304, 1024: 1024, 3072: 768, 4096: 1024}


@pytest.mark.parametrize("trait", TRAITS)
@pytest.mark.parametrize("k", sorted(DEPTHS))
@pytest.mark.parametrize("m", [1, 31, 80, 96, 288, 1024])
def test_matmul_traits_over_m_and_k(dev, trait, k, m):
    """Every storage trait at one row, ragged M under and over a 16-row
    fragment, the beam runs' 80, the headline's 96 and 288, and eight
    128-row slabs, at the four decoder depths: one launch, within one bf16
    step of the plain version's largest output."""
    w, x = _weight_and_x(dev, torch.bfloat16, m, k, DEPTHS[k], m + k)
    fn, ref, attr, args = _trait_case(trait, w)
    _check_kernel(fn, ref, (fn, attr), x, *args)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("trait", TRAITS)
@pytest.mark.parametrize("m,k", [(96, 768), (7, 3072), (300, 1024)])
def test_matmul_two_runs_are_bit_equal(dev, trait, m, k, dtype):
    """The K splits of a tile are summed in a fixed order: two runs of one
    call give the same bits (8, 8 and 4 or 2 splits here)."""
    w, x = _weight_and_x(dev, dtype, m, k, DEPTHS[k], m * k)
    fn, _, _, args = _trait_case(trait, w)
    first = fn(x, *args)
    for _ in range(3):
        assert torch.equal(fn(x, *args), first)


def test_4bit_wrappers_reject_what_the_kernels_do_not_take(dev):
    """The int4, NF4 and group-asym wrappers raise on every shape, type and
    pointer their kernels do not take; none reroutes to its plain
    version."""
    x = torch.zeros(2, 256, device=dev)
    nib = torch.zeros(128, 64, dtype=torch.int8, device=dev)
    col = torch.ones(1, 64, device=dev)
    grp = torch.ones(4, 64, device=dev)
    with pytest.raises(ValueError):  # K/2 rows expected, K given
        int4_matmul(x, torch.zeros(256, 64, dtype=torch.int8, device=dev), col)
    with pytest.raises(ValueError):  # uint8 nibbles
        int4_matmul(x, nib.view(torch.uint8), col)
    with pytest.raises(ValueError):  # N not a multiple of 64
        int4_matmul(x, torch.zeros(128, 96, dtype=torch.int8, device=dev),
                    torch.ones(1, 96, device=dev))
    with pytest.raises(ValueError):  # K/2 not a multiple of 32
        int4_matmul(torch.zeros(2, 96, device=dev),
                    torch.zeros(48, 64, dtype=torch.int8, device=dev), col)
    with pytest.raises(ValueError):  # a column scale short of N
        int4_matmul(x, nib, col[:, :32])
    with pytest.raises(ValueError):  # nibbles at an offset that breaks 16-byte loads
        off = torch.zeros(128 * 64 + 8, dtype=torch.int8, device=dev)[8:].view(128, 64)
        int4_matmul(x, off, col)
    with pytest.raises(TypeError):  # float64 is not a kernel dtype
        int4_matmul(x.double(), nib, col)
    with pytest.raises(ValueError):  # not a codebook kind
        nf4_matmul(x, nib, grp, "int4", 64)
    with pytest.raises(ValueError):  # block scales of the wrong shape
        nf4_matmul(x, nib, grp[:2], "nf4", 64)
    with pytest.raises(ValueError):  # int8 double-quant codes, not folded
        nf4_matmul(x, nib, grp.to(torch.int8), "nf4", 64)
    with pytest.raises(ValueError):  # K not a whole number of blocks
        nf4_matmul(x, nib, torch.ones(3, 64, device=dev), "fp4", 96)
    with pytest.raises(ValueError):  # (K, N) int8: uint8 values expected
        group_asym_matmul(x, torch.zeros(256, 64, dtype=torch.int8, device=dev),
                          grp[:2], grp[:2], 128)
    with pytest.raises(ValueError):  # (K/2, N) uint8: int8 nibbles expected
        group_asym_matmul(x, nib.view(torch.uint8), grp, grp, 64)
    with pytest.raises(ValueError):  # a zero of the wrong shape
        group_asym_matmul(x, nib, grp, grp[:2], 64)
    with pytest.raises(ValueError):  # scales on the CPU
        group_asym_matmul(x, nib, grp.cpu(), grp, 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,n_mels,seed", [
    pytest.param(2, 20480, 80, 20480, id="2-20480"),
    pytest.param(1, 480_000, 80, 480_000, id="1-480000"),
    *(pytest.param(b, t, n, t + b, id=f"{b}-{t}-{n}")
      for b, t, n in ((96, 480_000, 80), (2, 480_000, 128), (3, 20483, 80),
                      (2, 20483, 128), (1, 1001, 80)))])
def test_log_mel(dev, dtype, b, t, n_mels, seed):
    """The kernel no less exact than its plain version: both held against
    the float64 log-mel on the same operands (`features.log_mel_f64`), the
    kernel's largest distance at most the plain version's + 5e-6. Two f32
    chains that sum in different orders each stray up to ~3e-5 from the
    exact value on rare ill-conditioned bins, so they cannot be held to 1e-5
    of each other everywhere; a bf16 power spectrum or mel product would be
    1e-4 or more further off. At the headline batch, at large-v3's 128 mels,
    and where T + 400 is no multiple of 4 (the padded rows get a wider
    stride); one launch a call."""
    g = torch.Generator(device=dev).manual_seed(seed)
    wav = torch.randn(b, t, generator=g, device=dev) * 0.1
    before = log_mel_cuda.launches
    got = log_mel_cuda(wav, n_mels, dtype)
    assert log_mel_cuda.launches == before + 1
    ref = features.log_mel(wav, n_mels, dtype)
    assert got.shape == ref.shape == (b, n_mels, t // 160)
    exact = features.log_mel_f64(wav, n_mels, dtype)
    err_k, err_p = (float((x.double() - exact).abs().max()) for x in (got, ref))
    print(f"log_mel ({b}, {t}) {n_mels} mels {dtype}: from the float64 log-mel, "
          f"kernel {err_k:.3g}, plain {err_p:.3g}")
    assert err_k <= err_p + 5e-6


@pytest.mark.parametrize("bh,kq,s_valid", [(12, 1, 1), (12, 3, 100),
                                           (384, 1, 1500), (20, 4, 1500),
                                           (20, 5, 1500), (192, 8, 1500),
                                           (12, 19, 300), (7, 16, 1500)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_cross_attention_grouped(dev, bh, kq, s_valid, dtype):
    g = torch.Generator(device=dev).manual_seed(bh + kq)
    s_pad = -(-s_valid // 128) * 128
    q = (torch.randn(bh, kq, 64, generator=g, device=dev) * 0.125).to(dtype)
    k_t = torch.randn(bh, 64, s_pad, generator=g, device=dev).to(dtype)
    v_t = torch.randn(bh, 64, s_pad, generator=g, device=dev).to(dtype)
    chunks = [min(8, kq - j) for j in range(0, kq, 8)]
    counter = "launches" + _COUNTER[dtype]

    def counts():
        return (getattr(decode_cross_attention_grouped, counter),
                getattr(decode_cross_attention_grouped, counter + "_wide"))

    narrow, wide = counts()
    got = decode_cross_attention_grouped(q, k_t, v_t, s_valid=s_valid)
    assert counts() == (narrow + sum(c <= 4 for c in chunks),
                        wide + sum(c > 4 for c in chunks))
    assert got.dtype == dtype
    ref = decode_cross_attention_grouped_ref(q, k_t, v_t, s_valid=s_valid)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))
    # padding is never read: poisoning it changes no output bit
    k_t[:, :, s_valid:] = 100.0
    v_t[:, :, s_valid:] = -77.0
    assert torch.equal(decode_cross_attention_grouped(q, k_t, v_t,
                                                      s_valid=s_valid), got)


@pytest.mark.parametrize("bh", [12, 192, 1152])
@pytest.mark.parametrize("s_valid", [1, 15, 16, 1500, 1536])
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_cross_attention_grouped_slots(dev, kind, dtype, s_valid, bh):
    """Every storage kind (K/V in q's type, int8, int4) under q in each of
    the three types, at 1 to 8 slots over one K/V: within one step of q's
    type of the plain version's largest output (1e-5 for f32), each call
    one launch, and two runs of one call bit-equal."""
    g = torch.Generator(device=dev).manual_seed(bh + s_valid)
    if kind == "fp":
        k, v, ks, vs = _cross_kv(dev, "bf16", bh, s_valid, bh, dtype)
        counter = "launches" + _COUNTER[dtype]
    else:
        k, v, ks, vs = _quantized_kv(dev, 8 if kind == "int8" else 4, bh, s_valid, bh)
        counter = "launches_" + kind
    for kq in range(1, 9):
        q = (torch.randn(bh, kq, 64, generator=g, device=dev) * 0.125).to(dtype)
        attr = counter + ("_wide" if kq > 4 else "")
        before = getattr(decode_cross_attention_grouped, attr)
        got = decode_cross_attention_grouped(q, k, v, ks, vs, s_valid)
        assert getattr(decode_cross_attention_grouped, attr) == before + 1
        ref = decode_cross_attention_grouped_ref(q, k, v, ks, vs, s_valid)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=_tol(dtype, float(ref.float().abs().max())),
                                   msg=lambda m: f"{kq} slots: {m}")
        assert torch.equal(decode_cross_attention_grouped(q, k, v, ks, vs, s_valid), got)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("b,s,h", [(2, 1500, 12), (3, 64, 2), (1, 200, 5)]
                         + [(2, s, h) for s in (1, 127, 128, 129, 1536, 3000)
                            for h in (1, 16, 20)])
def test_transpose_quant_kv(dev, dtype, b, s, h):
    """int8 codes and f32 scales equal to the plain version bit for bit
    (the same f32 reciprocal, IEEE quotients and half-to-even rounding),
    for S ending a 128-position tile anywhere and H up to large-v3's 20."""
    g = torch.Generator(device=dev).manual_seed(b * s + h)
    x = (torch.randn(b, s, h * 64, generator=g, device=dev) * 0.4).to(dtype)
    before = transpose_quant_kv.launches
    q, sc = transpose_quant_kv(x, h)
    assert transpose_quant_kv.launches == before + 1
    q_ref, sc_ref = transpose_quant_kv_ref(x, h)
    assert q.shape == q_ref.shape and sc.shape == sc_ref.shape
    assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_transpose_quant_kv_offset(dev, dtype, offset):
    """x at a storage offset of `offset` elements: where that breaks the
    kernel's 16-byte loads the wrapper raises ValueError before any launch
    (the plain version never runs on the card); otherwise the codes and
    scales are right."""
    g = torch.Generator(device=dev).manual_seed(offset)
    flat = (torch.randn(offset + 2 * 300 * 192, generator=g, device=dev) * 0.4).to(dtype)
    x = flat[offset:].view(2, 300, 192)
    before = transpose_quant_kv.launches
    if (offset * x.element_size()) % 16:
        with pytest.raises(ValueError):
            transpose_quant_kv(x, 3)
        assert transpose_quant_kv.launches == before
        return
    q, sc = transpose_quant_kv(x, 3)
    assert transpose_quant_kv.launches == before + 1
    q_ref, sc_ref = transpose_quant_kv_ref(x, 3)
    assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)


def _quantized_kv(dev, bits, bh, s_valid, seed):
    """Seeded int8 or split-half int4 K/V and scales, quantized on the card
    by the plain quantizers (positions >= s_valid are quantized zeros)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s_pad = -(-s_valid // 128) * 128
    out = []
    for _ in range(2):
        x = torch.randn(1, s_pad, bh * 64, generator=g, device=dev)
        x[:, s_valid:] = 0
        data, scale = transpose_quant_kv_ref(x, bh)
        if bits == 4:
            data, scale = whisper._quant_kv4_t(data.float() * scale)
        out.append((data, scale))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bh,kq,s_valid", [(12, 1, 1), (12, 3, 100),
                                           (1152, 1, 1500), (20, 4, 1500),
                                           (192, 5, 1500), (20, 8, 100),
                                           (12, 19, 1500)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_cross_attention_grouped_quantized(dev, bits, bh, kq, s_valid, dtype):
    """int8 / int4 bodies, q in each of the three types, within one step of
    q's type of the plain version's largest output; poisoning the padding (codes and scales) changes no
    output bit; each body counts its own launches, one for every 8 slots,
    those of more than 4 slots under `_wide`."""
    g = torch.Generator(device=dev).manual_seed(bh + kq + bits)
    q = (torch.randn(bh, kq, 64, generator=g, device=dev) * 0.125).to(dtype)
    k, v, ks, vs = _quantized_kv(dev, bits, bh, s_valid, bh + bits)
    counter = "launches_int4" if bits == 4 else "launches_int8"
    chunks = [min(8, kq - j) for j in range(0, kq, 8)]

    def counts():
        return (getattr(decode_cross_attention_grouped, counter),
                getattr(decode_cross_attention_grouped, counter + "_wide"))

    narrow, wide = counts()
    got = decode_cross_attention_grouped(q, k, v, ks, vs, s_valid)
    assert counts() == (narrow + sum(c <= 4 for c in chunks),
                        wide + sum(c > 4 for c in chunks))
    ref = decode_cross_attention_grouped_ref(q, k, v, ks, vs, s_valid)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))
    for t in (k, v):
        t[:, :, s_valid:] = 99
    for t in (ks, vs):
        t[:, :, s_valid:] = float("inf")
    assert torch.equal(decode_cross_attention_grouped(q, k, v, ks, vs, s_valid),
                       got)


def _mixed_start(dev, bh, pos):
    """(BH,) int32 starts: 0, pos itself (that row attends to the fresh row
    alone) and values between."""
    start = torch.arange(bh, device=dev) * 3 % (pos + 1)
    start[1] = pos
    return start.to(torch.int32)


@pytest.mark.parametrize("with_start", [False, True])
@pytest.mark.parametrize("s,pos", [(64, 0), (64, 5), (64, 63), (448, 300)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_self_attention_update(dev, s, pos, with_start, dtype):
    g = torch.Generator(device=dev).manual_seed(s + pos)
    bh = 24
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    kn, vn = (torch.randn(2, bh, 64, generator=g, device=dev)).to(dtype)
    kc = torch.randn(bh, s, 64, generator=g, device=dev).to(dtype)
    vc = torch.randn(bh, s, 64, generator=g, device=dev).to(dtype)
    kr, vr = kc.clone(), vc.clone()
    start = _mixed_start(dev, bh, pos) if with_start else None
    counter = "launches" + _COUNTER[dtype] + ("_start" if with_start else "")
    before = getattr(decode_self_attention_update, counter)
    got = decode_self_attention_update(q, kn, vn, kc, vc, pos, start=start)
    assert getattr(decode_self_attention_update, counter) == before + 1
    ref = decode_self_attention_update_ref(q, kn, vn, kr, vr, pos, start=start)
    if with_start:   # row 1 attends to the row just written only
        assert torch.equal(got[1], vn[1])
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))


@pytest.mark.parametrize("with_start", [False, True])
@pytest.mark.parametrize("s,pos", [(64, 0), (64, 30), (64, 63), (448, 300)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_self_attention_update_int8(dev, s, pos, with_start, dtype):
    """Rows and scales written equal to the plain version's bit for bit;
    output within one step of q's type of its largest magnitude; with and without
    a mixed `start`, each counted on its own."""
    g = torch.Generator(device=dev).manual_seed(s + pos + 1)
    bh = 36
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    kn, vn = (torch.randn(2, bh, 64, generator=g, device=dev) * 2).to(dtype)
    kc, vc = torch.randint(-127, 128, (2, bh, s, 64), generator=g, device=dev,
                           dtype=torch.int8)
    ks, vs = torch.rand(2, bh, s, generator=g, device=dev) * 0.03 + 0.001
    bufs = [t.clone() for t in (kc, vc, ks, vs)]
    refs = [t.clone() for t in (kc, vc, ks, vs)]
    start = _mixed_start(dev, bh, pos) if with_start else None
    counter = "launches_start" if with_start else "launches"
    before = getattr(decode_self_attention_update_int8, counter)
    got = decode_self_attention_update_int8(q, kn, vn, *bufs, pos, start=start)
    assert getattr(decode_self_attention_update_int8, counter) == before + 1
    ref = decode_self_attention_update_int8_ref(q, kn, vn, *refs, pos, start=start)
    for a, b in zip(bufs, refs):
        assert torch.equal(a, b)
    assert not torch.equal(bufs[0][:, pos], kc[:, pos])
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))


@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("bh,s,pos", [(1152, 64, 30), (1, 64, 0), (1, 64, 63),
                                      (13, 64, 0), (13, 64, 63), (2, 12288, 12287)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_self_attention_int8_rows(dev, bh, s, pos, with_start, dtype):
    """The int8 update at the headline's (1152, 64, 64) and pos 30, at one and
    13 rows (a block's 4 warps not all used) at pos 0 and 63, and over a
    12288-row cache (192 passes of 64 positions): codes and scales equal to
    the plain version's, the output within one step of q's type, and the
    read-only kernel on the cache it wrote equal to its output bit for bit;
    each launch counted."""
    g = torch.Generator(device=dev).manual_seed(bh + s + pos)
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    kn, vn = (torch.randn(2, bh, 64, generator=g, device=dev) * 2).to(dtype)
    kc, vc = torch.randint(-127, 128, (2, bh, s, 64), generator=g, device=dev,
                           dtype=torch.int8)
    ks, vs = torch.rand(2, bh, s, generator=g, device=dev) * 0.03 + 0.001
    bufs = [t.clone() for t in (kc, vc, ks, vs)]
    refs = [t.clone() for t in (kc, vc, ks, vs)]
    start = None
    if with_start:
        start = (_mixed_start(dev, bh, pos) if bh > 1 else
                 torch.full((1,), pos // 2, dtype=torch.int32, device=dev))
    suffix = "_start" if with_start else ""
    before = getattr(decode_self_attention_update_int8, "launches" + suffix)
    got = decode_self_attention_update_int8(q, kn, vn, *bufs, pos, start=start)
    assert getattr(decode_self_attention_update_int8, "launches" + suffix) == before + 1
    ref = decode_self_attention_update_int8_ref(q, kn, vn, *refs, pos, start=start)
    for a, b in zip(bufs, refs):
        assert torch.equal(a, b)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))
    before = getattr(decode_self_attention, "launches_int8" + suffix)
    again = decode_self_attention(q, bufs[0], bufs[1], pos, start=start,
                                  k_scale=bufs[2], v_scale=bufs[3])
    assert getattr(decode_self_attention, "launches_int8" + suffix) == before + 1
    assert torch.equal(again, got)
    for a, b in zip(bufs, refs):
        assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 32, device=dev)
    with pytest.raises(ValueError):  # head dim 32
        decode_self_attention_update(x, x, x, torch.zeros(4, 8, 32, device=dev),
                                     torch.zeros(4, 8, 32, device=dev), 1)
    row = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(4, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # an int64 start
        decode_self_attention_update(row, row, row, cache, cache.clone(), 1,
                                     start=torch.zeros(4, dtype=torch.long, device=dev))
    with pytest.raises(ValueError):  # a start per batch row, not per (b, h)
        decode_self_attention_update(row, row, row, cache, cache.clone(), 1,
                                     start=torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # start on the CPU
        decode_self_attention_update(row, row, row, cache, cache.clone(), 1,
                                     start=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):  # q and fp K/V of two types
        decode_cross_attention_grouped(torch.zeros(4, 1, 64, device=dev),
                                       torch.zeros(4, 64, 128, device=dev).half(),
                                       torch.zeros(4, 64, 128, device=dev).half())
    with pytest.raises(TypeError):  # float64 is no kernel type
        decode_cross_attention_grouped(
            torch.zeros(4, 1, 64, device=dev, dtype=torch.float64),
            torch.zeros(4, 64, 128, device=dev, dtype=torch.float64),
            torch.zeros(4, 64, 128, device=dev, dtype=torch.float64))
    with pytest.raises(TypeError):  # f32 rows over a bf16 cache
        decode_self_attention_update(*torch.zeros(3, 4, 64, device=dev), cache,
                                     cache.clone(), 1)
    with pytest.raises(ValueError):  # w at an offset that breaks 16-byte loads
        int8_matmul(torch.zeros(2, 64, device=dev),
                    torch.zeros(64 * 64 + 8, dtype=torch.int8,
                                device=dev)[8:].view(64, 64),
                    torch.ones(1, 64, device=dev))
    with pytest.raises(ValueError):  # N not a multiple of 64
        int8_matmul(torch.zeros(2, 64, device=dev),
                    torch.zeros(64, 96, dtype=torch.int8, device=dev),
                    torch.ones(1, 96, device=dev))
    with pytest.raises(TypeError):  # float64 is not a kernel dtype
        int8_matmul(torch.zeros(2, 64, device=dev, dtype=torch.float64),
                    torch.zeros(64, 64, dtype=torch.int8, device=dev),
                    torch.ones(1, 64, device=dev))


def test_quantized_wrappers_reject_what_the_kernels_do_not_take(dev):
    """int8/int4 K/V, the transpose + quantize and the int8 cache update
    raise on every shape, type and pointer their kernels do not take; none
    reroutes to its plain version."""
    bf, i8 = torch.bfloat16, torch.int8
    q = torch.zeros(4, 1, 64, device=dev, dtype=bf)
    kv = torch.zeros(4, 64, 128, device=dev, dtype=i8)
    sc = torch.ones(4, 1, 128, device=dev)
    with pytest.raises(ValueError):  # a missing v scale
        decode_cross_attention_grouped(q, kv, kv, sc, None)
    with pytest.raises(TypeError):  # float64 q
        decode_cross_attention_grouped(q.double(), kv, kv, sc, sc)
    with pytest.raises(TypeError):  # bf16 K/V with scales
        decode_cross_attention_grouped(q, kv.to(bf), kv.to(bf), sc, sc)
    with pytest.raises(ValueError):  # 33 stored rows: neither Dh nor Dh/2
        odd = torch.zeros(4, 33, 128, device=dev, dtype=i8)
        decode_cross_attention_grouped(q, odd, odd, sc, sc)
    with pytest.raises(ValueError):  # int8 S_pad not a multiple of 16
        kv8 = torch.zeros(4, 64, 136, device=dev, dtype=i8)
        sc8 = torch.ones(4, 1, 136, device=dev)
        decode_cross_attention_grouped(q, kv8, kv8, sc8, sc8, 130)
    with pytest.raises(ValueError):  # K/V at an offset that breaks 16-byte loads
        off = torch.zeros(4 * 64 * 128 + 8, device=dev, dtype=i8)[8:].view(4, 64, 128)
        decode_cross_attention_grouped(q, off, kv, sc, sc)
    with pytest.raises(ValueError):  # scales of the wrong shape
        decode_cross_attention_grouped(q, kv, kv, sc[:, :, :64], sc[:, :, :64])
    with pytest.raises(ValueError):  # scales at an offset that breaks 16-byte copies
        sc_off = torch.ones(4 * 128 + 1, device=dev)[1:].view(4, 1, 128)
        decode_cross_attention_grouped(q, kv, kv, sc_off, sc_off)
    with pytest.raises(ValueError):  # head dim 48
        transpose_quant_kv(torch.zeros(1, 10, 96, device=dev, dtype=bf), 2)
    with pytest.raises(TypeError):  # float64 input
        transpose_quant_kv(torch.zeros(1, 10, 128, device=dev,
                                       dtype=torch.float64), 2)
    row = torch.zeros(4, 64, device=dev, dtype=bf)
    cache = torch.zeros(4, 8, 64, device=dev, dtype=i8)
    scale = torch.ones(4, 8, device=dev)
    with pytest.raises(TypeError):  # a bf16 cache
        decode_self_attention_update_int8(row, row, row, cache.to(bf),
                                          cache.to(bf), scale, scale, 1)
    with pytest.raises(TypeError):  # q of another type than the fresh rows
        decode_self_attention_update_int8(row.float(), row, row,
                                          cache, cache, scale, scale, 1)
    with pytest.raises(ValueError):  # pos past the cache
        decode_self_attention_update_int8(row, row, row, cache, cache, scale,
                                          scale, 8)
    with pytest.raises(ValueError):  # scales of the wrong shape
        decode_self_attention_update_int8(row, row, row, cache, cache,
                                          scale[:, :4], scale[:, :4], 1)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_scores_stay_f32(dev, causal):
    """bf16 attention with scores near 30 to 45, where a bf16 score is off
    by up to 0.125, against a float64 reference of the JAX semantics (f32
    scores, bf16 probabilities): within one bf16 step of the output's scale,
    which bf16-rounded scores would miss by far."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, h, t, dh = 1, 4, 1500, 64
    q = torch.randn(b, h, t, dh, generator=g, device=dev) * 4
    k = torch.randn(b, h, t, dh, generator=g, device=dev)
    q[..., 0], k[..., 0] = 8.0, 30.0   # q is scaled by 1/8: +30 on every score
    q, k = q.bfloat16(), k.bfloat16()
    v = torch.randn(b, h, t, dh, generator=g, device=dev).bfloat16()
    i = torch.arange(t, device=dev)
    mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e9) if causal else None
    got = whisper.attention(q, k, v, mask).double().cpu()
    q64, k64, v64 = (x.double().cpu() for x in (q, k, v))
    scores = (q64 * dh ** -0.5) @ k64.transpose(-1, -2)
    if causal:
        scores = scores + mask.double().cpu()
    probs = torch.softmax(scores, dim=-1).bfloat16().double()
    ref = probs @ v64
    assert float((got - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


def _strided_qkv(dev, b, h, t, seed, scale=1.0):
    """(B, H, T, 64) bf16 views of (B, T, H*64) projections, as the model's
    `split_heads` leaves them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [whisper.split_heads((torch.randn(b, t, h * 64, generator=g, device=dev)
                                 * (scale if i == 0 else 1.0)).bfloat16(), h)
            for i in range(3)]


@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 64), (1, 2, 129), (2, 4, 256),
                                   (1, 12, 300), (2, 12, 1500), (1, 2, 2000),
                                   (1, 1, 1500), (1, 1, 1499), (1, 12, 257),
                                   (1, 12, 1536), (96, 12, 256), (96, 12, 1500)])
def test_encoder_attention(dev, b, h, t):
    """Within one bf16 step (2**-7) of the plain version's largest output,
    at lengths around the 128-key tile and the 128-row block (whole tiles,
    one key or row over, the ragged 1500 and 1499), at B*H of 1, 12 and
    1152, on strided inputs; the output's memory is (B, T, H, 64), so merging heads is a
    view; rows and keys past T leave no trace (NaN-free)."""
    q, k, v = _strided_qkv(dev, b, h, t, b * h + t)
    before = encoder_attention.launches
    got = encoder_attention(q, k, v)
    assert encoder_attention.launches == before + 1
    ref = encoder_attention_ref(q, k, v)
    assert got.shape == (b, h, t, 64) and got.dtype == torch.bfloat16
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(torch.bfloat16, float(ref.float().abs().max())))
    # contiguous (B, H, T, 64) inputs give the same bits
    assert torch.equal(encoder_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous()), got)


def test_encoder_attention_peaked_scores(dev):
    """Scores of order 30 to 45 with a few dominant keys per row (q scaled
    by 4, a constant +30 on every score): the running maximum moves while
    the keys stream by, and f32 scores are needed."""
    q, k, v = _strided_qkv(dev, 1, 4, 1500, 5, scale=4.0)
    q, k = q.clone(), k.clone()
    q[..., 0], k[..., 0] = 8.0, 30.0
    got, ref = encoder_attention(q, k, v), encoder_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(torch.bfloat16, float(ref.float().abs().max())))


def test_model_attention_dispatch(dev):
    """On the card `attention()` launches the encoder kernel for unmasked
    bf16 calls with Tq = Tk >= 256 and for nothing else."""
    def launched(q, k, v, mask=None):
        before = encoder_attention.launches
        whisper.attention(q, k, v, mask)
        return encoder_attention.launches - before

    q, k, v = _strided_qkv(dev, 1, 2, 256, 1)
    assert launched(q, k, v) == 1
    assert launched(q, k, v, torch.zeros(256, 256, device=dev)) == 0
    assert launched(q.float(), k.float(), v.float()) == 0
    assert launched(q[:, :, :255], k[:, :, :255], v[:, :, :255]) == 0
    assert launched(q[:, :, :1], k, v) == 0


def test_encoder_attention_rejects_what_the_kernel_does_not_take(dev):
    bf = torch.bfloat16
    x = torch.zeros(1, 2, 256, 64, device=dev, dtype=bf)
    with pytest.raises(TypeError):  # f32
        encoder_attention(x.float(), x.float(), x.float())
    with pytest.raises(ValueError):  # head dim 32
        encoder_attention(x[..., :32], x[..., :32], x[..., :32])
    with pytest.raises(ValueError):  # Tq != Tk
        encoder_attention(x[:, :, :100], x, x)
    with pytest.raises(ValueError):  # rows at an offset that breaks 16-byte copies
        off = torch.zeros(2 * 256 * 64 + 4, device=dev, dtype=bf)[4:].view(1, 2, 256, 64)
        encoder_attention(x, off, x)
    with pytest.raises(ValueError):  # a transposed head dim
        t = torch.zeros(1, 2, 64, 256, device=dev, dtype=bf).transpose(2, 3)
        encoder_attention(t, x, x)


# (M, K, N): one row, a ragged M under one tile, the encoder's 1500 rows of
# one utterance; K and N that are no multiples of the 64-deep K tile or the
# 64- and 128-wide output tiles; whisper-small's fc2 depth
W8A8_SHAPES = [(1, 64, 64), (17, 80, 48), (1500, 768, 2304), (1, 3072, 768),
               (17, 3072, 784), (1500, 208, 144), (4200, 768, 768)]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("m,k,n", W8A8_SHAPES)
def test_w8a8_matmul(dev, dtype, m, k, n, static):
    """Bit-equal to the plain version (integer sums have no order; the same
    IEEE division, half-to-even rounding and left-to-right epilogue), with an
    all-zero row and, under the static scale, values that clip at +-127;
    both tilings (M = 4200 with N = 768 fills the card with 128 x 128
    tiles); each body counts its own launches."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    q = quantize_int8(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = (torch.randn(m, k, generator=g, device=dev) * 1.7).to(dtype)
    x[m // 2] = 0.0
    act_scale = torch.tensor(0.031, device=dev) if static else None
    counter = "launches_static" if static else "launches"
    before = getattr(w8a8_matmul, counter)
    got = w8a8_matmul(x, q.data, q.scale, act_scale)
    assert getattr(w8a8_matmul, counter) == before + 1
    ref = w8a8_matmul_ref(x, q.data, q.scale, act_scale)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, ref)
    assert not got[m // 2].any()


# (K, N) of every linear of whisper-tiny, -small and -medium (fused qkv),
# and a ragged N = 16 x 49
W8A8_KN = [(384, 1152), (384, 384), (384, 1536), (1536, 384),
           (768, 2304), (768, 768), (768, 3072), (3072, 768),
           (1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024), (768, 784)]


@pytest.mark.parametrize("m", [1, 17, 96, 288, 1025, 6000])
@pytest.mark.parametrize("k,n", W8A8_KN)
def test_w8a8_matmul_whisper_linears(dev, m, k, n):
    """Both bodies (the fused one up to M = 1024, the quantize pass and the
    wgmma GEMM above) bit-equal to the plain version, dynamic and static,
    x in f32, bf16 and f16, and two runs of one call bit-equal."""
    g = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
    q = quantize_int8(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x32 = torch.randn(m, k, generator=g, device=dev) * 1.7
    for dtype in FLOATS:
        x = x32.to(dtype)
        for act_scale in (None, torch.tensor(0.029, device=dev)):
            got = w8a8_matmul(x, q.data, q.scale, act_scale)
            ref = w8a8_matmul_ref(x, q.data, q.scale, act_scale)
            what = f"{_IDS[dtype]} {'static' if act_scale is not None else 'dynamic'}"
            assert got.dtype == dtype and got.shape == (m, n), what
            assert torch.equal(got, ref), (what, float((got.float() - ref.float()).abs().max()))
            assert torch.equal(w8a8_matmul(x, q.data, q.scale, act_scale), got), what


def test_w8a8_matmul_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros(2, 64, device=dev)
    w = torch.zeros(64, 32, dtype=torch.int8, device=dev)
    s = torch.ones(1, 32, device=dev)
    with pytest.raises(ValueError):   # K not a multiple of 16
        w8a8_matmul(x[:, :40].contiguous(), w[:40].contiguous(), s)
    with pytest.raises(ValueError):   # int4 nibbles passed as they are stored
        w8a8_matmul(x, w[:32].contiguous(), s)
    with pytest.raises(TypeError):    # float64 activations
        w8a8_matmul(x.double(), w, s)
    with pytest.raises(ValueError):   # a static scale of two values
        w8a8_matmul(x, w, s, torch.ones(2, device=dev))
    with pytest.raises(ValueError):   # a static scale left on the CPU
        w8a8_matmul(x, w, s, torch.tensor(0.5))
    with pytest.raises(ValueError):   # x at an offset that breaks 16-byte loads
        off = torch.zeros(2 * 64 + 1, device=dev)[1:].view(2, 64)
        w8a8_matmul(off, w, s)
    with pytest.raises(ValueError):   # a K range no split of 8 keeps in shared memory
        big = torch.zeros(2, 64 * 67 * 2, device=dev)
        w8a8_matmul(big, torch.zeros(64 * 67 * 2, 32, dtype=torch.int8, device=dev), s)


def _cross_kv(dev, kind, bh, s_valid, seed, dtype=torch.bfloat16):
    if kind == "bf16":   # K/V in q's own type
        g = torch.Generator(device=dev).manual_seed(seed)
        s_pad = -(-s_valid // 128) * 128
        k, v = (torch.randn(bh, 64, s_pad, generator=g, device=dev).to(dtype)
                for _ in range(2))
        return k, v, None, None
    return _quantized_kv(dev, 4 if kind == "int4" else 8, bh, s_valid, seed)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("bh,s_valid", [(1, 1), (1, 1500), (12, 1500), (36, 1500),
                                        (12, 100), (36, 129), (7, 1025), (50, 300),
                                        (13, 3000), (24, 3000)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_cross_attention_one_query(dev, kind, bh, s_valid, dtype):
    """Each storage body (kind "bf16": K/V in q's own type), q in each of the
    three types, within one step of q's type of the plain version's largest
    output, and of the grouped kernel at one slot; one position, one block
    per row, a span that ends inside a chunk, B*H of 1, 12 and 36, and
    s_valid 3000 (several tiles a warp, a cluster of 8 at 13 rows, of 6 at 24);
    poisoning the padding (data and scales) changes no output bit; each body
    counts its own launches."""
    g = torch.Generator(device=dev).manual_seed(bh + s_valid)
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    k, v, ks, vs = _cross_kv(dev, kind, bh, s_valid, bh + s_valid, dtype)
    counter = {"bf16": "launches" + _COUNTER[dtype], "int8": "launches_int8",
               "int4": "launches_int4"}[kind]
    before = getattr(decode_cross_attention, counter)
    got = decode_cross_attention(q, k, v, ks, vs, s_valid)
    assert getattr(decode_cross_attention, counter) == before + 1
    ref = decode_cross_attention_ref(q, k, v, ks, vs, s_valid)
    assert got.shape == (bh, 64) and got.dtype == dtype
    tol = _tol(dtype, float(ref.float().abs().max()))
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol)
    grouped = decode_cross_attention_grouped(q[:, None, :].contiguous(), k, v, ks, vs,
                                             s_valid)[:, 0, :]
    torch.testing.assert_close(got.float(), grouped.float(), rtol=0, atol=tol)
    for t in (k, v):
        t[:, :, s_valid:] = 99
    if ks is not None:
        for t in (ks, vs):
            t[:, :, s_valid:] = float("inf")
    assert torch.equal(decode_cross_attention(q, k, v, ks, vs, s_valid), got)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_cross_attention_one_query_two_runs_bit_equal(dev, kind, dtype):
    """The blocks of a cluster combine in a fixed order, with no atomics:
    two calls on the same inputs give the same bits."""
    bh, s_valid = 12, 1500
    g = torch.Generator(device=dev).manual_seed(7)
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    kv = _cross_kv(dev, kind, bh, s_valid, 7, dtype)
    first = decode_cross_attention(q, *kv, s_valid)
    assert torch.equal(decode_cross_attention(q, *kv, s_valid), first)


def test_cross_attention_one_query_rejects_what_the_kernel_does_not_take(dev):
    bf, i8 = torch.bfloat16, torch.int8
    q = torch.zeros(4, 64, device=dev, dtype=bf)
    kv = torch.zeros(4, 64, 128, device=dev, dtype=i8)
    sc = torch.ones(4, 1, 128, device=dev)
    with pytest.raises(ValueError):   # query slots: the grouped function's shape
        decode_cross_attention(q[:, None, :], kv, kv, sc, sc)
    with pytest.raises(TypeError):    # float64 q
        decode_cross_attention(q.double(), kv, kv, sc, sc)
    with pytest.raises(ValueError):   # a missing k scale
        decode_cross_attention(q, kv, kv, None, sc)
    with pytest.raises(ValueError):   # s_valid past S_pad
        decode_cross_attention(q, kv, kv, sc, sc, 129)
    with pytest.raises(ValueError):   # K/V of another row count
        decode_cross_attention(q, kv[:3], kv[:3], sc, sc)


@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bh,s,pos", [(1, 64, 0), (12, 64, 63), (36, 64, 30),
                                      (24, 448, 300)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_self_attention_read_only(dev, bh, s, pos, int8, with_start, dtype):
    """On the cache that the update kernel wrote, the read-only kernel
    returns the update kernel's output bit for bit, writes nothing, lies
    within one bf16 step of its plain version, and counts its four bodies
    apart; pos 0 and pos S - 1, B*H of 1, 12 and 36."""
    g = torch.Generator(device=dev).manual_seed(bh + s + pos)
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    kn, vn = (torch.randn(2, bh, 64, generator=g, device=dev) * 2).to(dtype)
    start = _mixed_start(dev, bh, pos) if with_start and bh > 1 else (
        torch.zeros(bh, dtype=torch.int32, device=dev) if with_start else None)
    if int8:
        kc, vc = torch.randint(-127, 128, (2, bh, s, 64), generator=g, device=dev,
                               dtype=torch.int8)
        ks, vs = torch.rand(2, bh, s, generator=g, device=dev) * 0.03 + 0.001
        bufs = [kc, vc, ks, vs]
        out_upd = decode_self_attention_update_int8(q, kn, vn, *bufs, pos, start=start)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        bufs = [torch.randn(bh, s, 64, generator=g, device=dev).to(dtype)
                for _ in range(2)]
        out_upd = decode_self_attention_update(q, kn, vn, *bufs, pos, start=start)
        scales = {}
    written = [t.clone() for t in bufs]
    counter = ("launches" + ("_int8" if int8 else _COUNTER[dtype])
               + ("_start" if with_start else ""))
    before = getattr(decode_self_attention, counter)
    got = decode_self_attention(q, bufs[0], bufs[1], pos, start=start, **scales)
    assert getattr(decode_self_attention, counter) == before + 1
    assert torch.equal(got, out_upd)
    assert all(torch.equal(a, b) for a, b in zip(bufs, written))
    ref = decode_self_attention_ref(q, bufs[0], bufs[1], pos, start=start, **scales)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))


def test_self_attention_read_only_rejects_what_the_kernel_does_not_take(dev):
    bf, i8 = torch.bfloat16, torch.int8
    row = torch.zeros(4, 64, device=dev, dtype=bf)
    cache = torch.zeros(4, 8, 64, device=dev, dtype=bf)
    scale = torch.ones(4, 8, device=dev)
    with pytest.raises(ValueError):   # pos past the cache
        decode_self_attention(row, cache, cache, 8)
    with pytest.raises(TypeError):    # a bf16 cache with scales
        decode_self_attention(row, cache, cache, 1, k_scale=scale, v_scale=scale)
    with pytest.raises(TypeError):    # an int8 cache without scales
        decode_self_attention(row, cache.to(i8), cache.to(i8), 1)
    with pytest.raises(ValueError):   # one scale only
        decode_self_attention(row, cache.to(i8), cache.to(i8), 1, k_scale=scale)
    with pytest.raises(TypeError):    # f32 q
        decode_self_attention(row.float(), cache, cache, 1)
    with pytest.raises(TypeError):    # an int64 start
        decode_self_attention(row, cache, cache, 1,
                              start=torch.zeros(4, dtype=torch.long, device=dev))
