"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes and in the dtypes each takes (chip_smoke.py covers the
whisper-small main-path shapes): mel, int8 matmul, grouped cross-attention
over bf16 / int8 / int4 K/V (1 to 8 slots and longer windows), the
one-query cross-attention over the same three storages, the cross-KV
transpose + int8 quantize, the fp and int8 self-attention cache updates
(with and without `start`), the read-only self-attention, the w8a8 matmul
(dynamic and static) and the encoder attention; the f32 and f16 bodies of
the decode attention kernels and of the matmuls; two runs of one matmul call
bit for bit; the wrappers' refusals; bf16 attention on the card against a float64 reference with
f32 scores; and the callers that bring caches of other lengths (the
speculative path's verify window and draft workspace, a prompt's `start`);
the serving workloads' callers (continuous batching's per-slot `start` over
a 128-row window after admits and a rebase, the streaming pool at partial
occupancy, a serving bucket of 8) with every kernel call held against its
plain version (`chip_smoke.checked_kernel_calls`); the w8a8 matmul at ragged
widths; every wrapper's refusal of inputs that need a gradient, the model's
plain attention under grad, a bf16 `nll_loss` gradient against CPU f32, and
the GPTQ solve against the CPU's; the encoder attention in f16 and f32; every
attention kernel past head dim 256 (the WIDE bodies: 257-1024, every kind
and q type, a 16384-row cache at 512). Marked `cuda`; every test skips where no
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


# ragged widths per storage trait, (M, K, N): K and N off every tile (a
# structured-pruned FFN of whisper-small keeps 922 of 3072 units), N a
# multiple of 16 but not of 64, N a multiple of 4 only, odd widths; the
# grouped kinds with groups of 16 (8 for uint8 HQQ) so that K can be ragged
RAGGED = {"int8": [(1, 922, 768), (96, 768, 922), (5, 33, 33), (40, 648, 100),
                   (7, 256, 96), (130, 640, 1920)],
          "int4": [(1, 922, 768), (96, 768, 922), (5, 34, 33), (40, 648, 100),
                   (7, 256, 96), (130, 640, 1920)],
          "nf4": [(1, 656, 768), (96, 768, 922), (5, 48, 33), (40, 656, 100),
                  (7, 256, 96), (130, 640, 1920)],
          "hqq4": [(1, 656, 768), (96, 768, 922), (5, 48, 33), (40, 656, 100),
                   (7, 256, 96), (130, 640, 1920)],
          "hqq8": [(1, 648, 768), (96, 768, 922), (5, 40, 33), (40, 648, 100),
                   (7, 256, 96), (130, 640, 1920)]}


def _ragged_case(trait, w):
    """`_trait_case` with groups small enough for a ragged K."""
    if trait == "nf4":
        q = quantize_nf4(w, block_size=16, double_quant=True, kind="nf4")
        return nf4_matmul, nf4_matmul_ref, "launches", (
            q.data, effective_block_scale(q).contiguous(), "nf4", 16)
    if trait in ("hqq4", "hqq8"):
        bits, attr = (4, "launches") if trait == "hqq4" else (8, "launches_u8")
        q = quantize_hqq(w, bits=bits, group_size=16 if bits == 4 else 8)
        return group_asym_matmul, group_asym_matmul_ref, attr, (
            q.data, q.scale, q.zero, q.block_size)
    return _trait_case(trait, w)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("trait", TRAITS)
def test_matmul_traits_at_ragged_widths(dev, trait, case, dtype):
    """Every storage trait at widths off the 64-column and 32-row tiles: one
    launch, within the tolerance of the plain version's largest output."""
    m, k, n = RAGGED[trait][case]
    w, x = _weight_and_x(dev, dtype, m, k, n, m + k + n)
    fn, ref, attr, args = _ragged_case(trait, w)
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
    version. An N that is no multiple of 64 and a K/2 that is no multiple
    of 32 are taken (the kernel predicates its last tiles): they compute,
    in one launch, what the plain version does."""
    x = torch.zeros(2, 256, device=dev)
    nib = torch.zeros(128, 64, dtype=torch.int8, device=dev)
    col = torch.ones(1, 64, device=dev)
    grp = torch.ones(4, 64, device=dev)
    with pytest.raises(ValueError):  # K/2 rows expected, K given
        int4_matmul(x, torch.zeros(256, 64, dtype=torch.int8, device=dev), col)
    with pytest.raises(ValueError):  # uint8 nibbles
        int4_matmul(x, nib.view(torch.uint8), col)
    g = torch.Generator(device=dev).manual_seed(96)
    x96 = torch.randn(2, 96, generator=g, device=dev)
    for xs, ws, cs in ((x, (128, 96), (1, 96)), (x96, (48, 64), (1, 64))):
        # N not a multiple of 64; K/2 not a multiple of 32: both computed
        wq = torch.randint(-128, 128, ws, generator=g, device=dev).to(torch.int8)
        _check_kernel(int4_matmul, int4_matmul_ref, (int4_matmul, "launches"),
                      xs, wq, torch.rand(cs, generator=g, device=dev) * 0.01)
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


def _quiet_windows(b: int, kind: str, seed: int):
    """Seeded 30 s windows of the kinds a streaming flush or a quiet stream
    gives the f32-DFT log-mel: `tail<s>` is s seconds of noise x 0.1 and
    then zeros, `quiet<a>` noise x a throughout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((b, 480_000)).astype(np.float32)
    if kind.startswith("tail"):
        wav[:, int(float(kind[4:]) * 16000):] = 0.0
        wav *= 0.1
    else:
        wav *= float(kind[5:])
    return torch.from_numpy(wav)


@pytest.mark.parametrize("kind", ["tail0.5", "tail2", "tail5", "quiet1e-2", "quiet1e-4"])
@pytest.mark.parametrize("b", [1, 32])
def test_log_mel_f32_on_tail_and_quiet_windows(dev, b, kind):
    """The f32-DFT body at batch 1 and 32 on windows of a streaming flush's
    kind (a few seconds of audio, then zeros) and on near-silent audio: no
    further from the float64 log-mel than the plain version + 5e-6."""
    wav = _quiet_windows(b, kind, b * 7 + len(kind)).to(dev)
    got = log_mel_cuda(wav, 80, torch.float32)
    ref = features.log_mel(wav, 80, torch.float32)
    exact = features.log_mel_f64(wav, 80, torch.float32)
    err_k, err_p = (float((x.double() - exact).abs().max()) for x in (got, ref))
    print(f"log_mel f32 ({b}, 480000) {kind}: from the float64 log-mel, "
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
    kernel's 16-byte loads the wrapper reads it through an aligned copy (the
    plain version never runs on the card); either way one launch, and the
    codes and scales are right."""
    g = torch.Generator(device=dev).manual_seed(offset)
    flat = (torch.randn(offset + 2 * 300 * 192, generator=g, device=dev) * 0.4).to(dtype)
    x = flat[offset:].view(2, 300, 192)
    before = transpose_quant_kv.launches
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
                                      (13, 64, 0), (13, 64, 63), (2, 12288, 12287),
                                      (2, 16384, 16383)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_self_attention_int8_rows(dev, bh, s, pos, with_start, dtype):
    """The int8 update at the headline's (1152, 64, 64) and pos 30, at one and
    13 rows (a block's 4 warps not all used) at pos 0 and 63, and over
    12288- and 16384-row caches (192 and 256 passes of 64 positions; the cap
    of 12288 rows is gone): codes and scales equal to
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


@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("bh,s,pos", [(384, 64, 30), (1, 64, 0), (1, 64, 63),
                                      (13, 64, 0), (13, 64, 63), (2, 12288, 12287),
                                      (2, 16384, 16383)])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_self_attention_fp_rows(dev, bh, s, pos, with_start, dtype):
    """The fp update at bf16-kv's (384, 64, 64) and pos 30, at one and 13
    rows (a block's 4 warps not all used) at pos 0 and 63, and over 12288-
    and 16384-row caches (384 and 512 passes of 32 positions; the cap of
    12288 rows is gone): caches equal to the plain
    version's bit for bit, the output within one step of q's type (a row
    whose start is pos returns its fresh v row exactly), and the read-only
    kernel on the cache it wrote equal to its output bit for bit, writing
    nothing; each launch counted."""
    g = torch.Generator(device=dev).manual_seed(bh + s + pos + 7)
    q = (torch.randn(bh, 64, generator=g, device=dev) * 0.125).to(dtype)
    kn, vn = (torch.randn(2, bh, 64, generator=g, device=dev)).to(dtype)
    bufs = [torch.randn(bh, s, 64, generator=g, device=dev).to(dtype)
            for _ in range(2)]
    refs = [t.clone() for t in bufs]
    start = None
    if with_start:
        start = (_mixed_start(dev, bh, pos) if bh > 1 else
                 torch.full((1,), pos // 2, dtype=torch.int32, device=dev))
    counter = "launches" + _COUNTER[dtype] + ("_start" if with_start else "")
    before = getattr(decode_self_attention_update, counter)
    got = decode_self_attention_update(q, kn, vn, *bufs, pos, start=start)
    assert getattr(decode_self_attention_update, counter) == before + 1
    ref = decode_self_attention_update_ref(q, kn, vn, *refs, pos, start=start)
    assert all(torch.equal(a, b) for a, b in zip(bufs, refs))
    assert got.dtype == dtype
    if with_start and bh > 1:   # row 1 attends to the row just written only
        assert torch.equal(got[1], vn[1])
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))
    before = getattr(decode_self_attention, counter)
    again = decode_self_attention(q, *bufs, pos, start=start)
    assert getattr(decode_self_attention, counter) == before + 1
    assert torch.equal(again, got)
    assert all(torch.equal(a, b) for a, b in zip(bufs, refs))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.ones(4, 257, device=dev)   # head dim 257: the WIDE body, no refusal
    caches = [torch.zeros(4, 8, 257, device=dev) for _ in range(2)]
    before = decode_self_attention_update.launches_wide_dh
    got = decode_self_attention_update(x, x, x, *caches, 1)
    assert decode_self_attention_update.launches_wide_dh == before + 1
    assert bool((caches[0][:, 1] == 1).all()) and bool((got == 1).all())
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
    # N not a multiple of 64: computed (the kernel predicates its last tile)
    g = torch.Generator(device=dev).manual_seed(64)
    _check_kernel(int8_matmul, int8_matmul_ref, (int8_matmul, "launches"),
                  torch.randn(2, 64, generator=g, device=dev),
                  torch.randint(-128, 128, (64, 96), generator=g,
                                device=dev).to(torch.int8),
                  torch.rand(1, 96, generator=g, device=dev) * 0.01)
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
    with pytest.raises(ValueError):  # scales of the wrong shape
        decode_cross_attention_grouped(q, kv, kv, sc[:, :, :64], sc[:, :, :64])
    # head dim 257, once refused: the WIDE bodies, held to the plain versions
    x257 = torch.randn(1, 10, 514, device=dev, dtype=bf)
    codes, scales = transpose_quant_kv(x257, 2)
    want = transpose_quant_kv_ref(x257, 2)
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
    q257 = torch.randn(4, 1, 257, device=dev, dtype=bf) * 257 ** -0.5
    kv257 = torch.randn(2, 4, 257, 128, device=dev, dtype=bf)
    got = decode_cross_attention_grouped(q257, *kv257)
    ref = decode_cross_attention_grouped_ref(q257, *kv257)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(bf, float(ref.float().abs().max())))
    with pytest.raises(ValueError, match="even head dim"):  # int4 K/V of an odd one
        packed = torch.zeros(4, 18, 128, device=dev, dtype=i8)
        decode_cross_attention_grouped(torch.zeros(4, 1, 37, device=dev, dtype=bf),
                                       packed, packed, sc, sc)
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
    bf16, f16 and f32 calls with Tq = Tk >= 256 (each counted in its type's
    counter) and for nothing else."""
    counters = ("launches", "launches_f32", "launches_f16")

    def launched(q, k, v, mask=None):
        before = [getattr(encoder_attention, c) for c in counters]
        whisper.attention(q, k, v, mask)
        return sum(getattr(encoder_attention, c) - b for c, b in zip(counters, before))

    q, k, v = _strided_qkv(dev, 1, 2, 256, 1)
    assert launched(q, k, v) == 1
    assert launched(q, k, v, torch.zeros(256, 256, device=dev)) == 0
    before = encoder_attention.launches_f32
    assert launched(q.float(), k.float(), v.float()) == 1
    assert encoder_attention.launches_f32 == before + 1
    before = encoder_attention.launches_f16
    assert launched(q.half(), k.half(), v.half()) == 1
    assert encoder_attention.launches_f16 == before + 1
    assert launched(q[:, :, :255], k[:, :, :255], v[:, :, :255]) == 0
    assert launched(q[:, :, :1], k, v) == 0


def test_encoder_attention_rejects_what_the_kernel_does_not_take(dev):
    """float64 and q, k, v of two types are refused, and so is Tq != Tk; f32
    and head dim 257 (the WIDE body), which the kernel once refused, are
    taken and held to the plain version."""
    bf = torch.bfloat16
    x = torch.zeros(1, 2, 256, 64, device=dev, dtype=bf)
    with pytest.raises(TypeError):  # float64
        encoder_attention(x.double(), x.double(), x.double())
    with pytest.raises(TypeError):  # q f32, k and v bf16
        encoder_attention(x.float(), x, x)
    g = torch.Generator(device=dev).manual_seed(257)
    y = torch.randn(1, 2, 256, 257, generator=g, device=dev, dtype=bf)
    before = encoder_attention.launches_wide_dh
    got, ref = encoder_attention(y, y, y), encoder_attention_ref(y, y, y)   # head dim 257
    assert encoder_attention.launches_wide_dh == before + 1
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(bf, float(ref.float().abs().max())))
    with pytest.raises(ValueError):  # Tq != Tk
        encoder_attention(x[:, :, :100], x, x)


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


# widths the kernels' ragged instantiation serves: whisper-small's FFN of 922
# units after `activation_guided_ffn_prune(0.3)`, odd, 8 past a multiple of
# 16, 4 past one, and a whole multiple of 16 beside them
W8A8_RAGGED = [922, 33, 648, 100, 96]


@pytest.mark.parametrize("m", [8, 96, 3000])
@pytest.mark.parametrize("n", W8A8_RAGGED)
@pytest.mark.parametrize("k", W8A8_RAGGED)
def test_w8a8_matmul_at_ragged_widths(dev, k, n, m):
    """Any K and N: dynamic and static, int8 and w4a8 codes (int4 unpacked
    to int8, as `ops.linear.kernel_call` passes them; K even), x in f32,
    bf16 and f16, bit-equal to the plain version at decode M (one launch)
    and at the encoder's 2 x 1500 rows (the quantize pass writing xq over
    K padded to 16, then the GEMM)."""
    from openai_whisper_compression_tpu_torch.ops.qtensor import unpack_int_sub8

    g = torch.Generator(device=dev).manual_seed(m * 7 + k * 3 + n)
    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    codes = [("int8", quantize_int8(w))]
    if k % 2 == 0:
        q4 = quantize_int_sub8(w, 4)
        codes.append(("w4a8", (unpack_int_sub8(q4.data, 4, k).to(torch.int8), q4.scale)))
    x32 = torch.randn(m, k, generator=g, device=dev) * 1.7
    x32[m // 2] = 0.0
    for kind, q in codes:
        data, scale = (q.data, q.scale) if kind == "int8" else q
        for dtype in FLOATS:
            x = x32.to(dtype)
            for act_scale in (None, torch.tensor(0.029, device=dev)):
                got = w8a8_matmul(x, data, scale, act_scale)
                ref = w8a8_matmul_ref(x, data, scale, act_scale)
                what = f"{kind} {_IDS[dtype]} {'static' if act_scale is not None else 'dynamic'}"
                assert got.dtype == dtype and got.shape == (m, n), what
                assert torch.equal(got, ref), (what, float((got.float() - ref.float()).abs().max()))


def _grad_inputs(dev):
    """(name, call, inputs) of every kernel wrapper at a small shape it
    takes; `call(*inputs)` launches it."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)

    def r(*shape, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * 0.5).to(dtype)

    q8 = quantize_int8(torch.randn(64, 64, generator=g, device=dev) * 0.02)
    q4 = quantize_int_sub8(torch.randn(256, 64, generator=g, device=dev) * 0.02, 4)
    nf = quantize_nf4(torch.randn(256, 64, generator=g, device=dev) * 0.02)
    hq = quantize_hqq(torch.randn(256, 64, generator=g, device=dev) * 0.02, bits=4)
    k_t, v_t = r(12, 64, 128), r(12, 64, 128)
    kc, vc = r(12, 64, 64), r(12, 64, 64)
    kc8 = torch.zeros(12, 64, 64, dtype=torch.int8, device=dev)
    ks8 = torch.ones(12, 64, device=dev)
    return [
        ("log_mel_cuda", lambda w: log_mel_cuda(w), [r(1, 4000, dtype=torch.float32)]),
        ("int8_matmul", lambda x: int8_matmul(x, q8.data, q8.scale), [r(4, 64)]),
        ("int4_matmul", lambda x: int4_matmul(x, q4.data, q4.scale), [r(4, 256)]),
        ("nf4_matmul", lambda x: nf4_matmul(x, nf.data, effective_block_scale(nf), "nf4",
                                            nf.block_size), [r(4, 256)]),
        ("group_asym_matmul", lambda x: group_asym_matmul(x, hq.data, hq.scale, hq.zero,
                                                          hq.block_size), [r(4, 256)]),
        ("w8a8_matmul", lambda x: w8a8_matmul(x, q8.data, q8.scale), [r(4, 64)]),
        ("transpose_quant_kv", lambda x: transpose_quant_kv(x, 2), [r(1, 100, 128)]),
        ("decode_cross_attention_grouped",
         lambda q: decode_cross_attention_grouped(q, k_t, v_t, None, None, 100),
         [r(12, 1, 64)]),
        ("decode_cross_attention",
         lambda q: decode_cross_attention(q, k_t, v_t, None, None, 100), [r(12, 64)]),
        ("decode_self_attention_update",
         lambda q, kn: decode_self_attention_update(q, kn, r(12, 64), kc, vc, 3),
         [r(12, 64), r(12, 64)]),
        ("decode_self_attention_update_int8",
         lambda q: decode_self_attention_update_int8(q, r(12, 64), r(12, 64), kc8,
                                                     kc8.clone(), ks8, ks8.clone(), 3),
         [r(12, 64)]),
        ("decode_self_attention", lambda q: decode_self_attention(q, kc, vc, 3), [r(12, 64)]),
        ("encoder_attention", lambda q: encoder_attention(q, q, q), [r(1, 2, 256, 64)]),
    ]


def test_every_kernel_wrapper_refuses_inputs_that_need_a_gradient(dev):
    """No kernel has a backward, and a launch writes a tensor with no
    autograd history: each wrapper raises (naming itself) on an input that
    requires grad while grad mode is on, and launches under no_grad and
    on inputs that do not require grad."""
    cases = _grad_inputs(dev)
    assert len(cases) == 13
    for name, call, inputs in cases:
        with pytest.raises(RuntimeError, match=name):
            call(*[t.clone().requires_grad_(True) for t in inputs])
        with torch.no_grad():
            call(*[t.clone().requires_grad_(True) for t in inputs])
        out = call(*inputs)
        assert out is not None and not (out[0] if isinstance(out, tuple) else out).requires_grad


def test_attention_takes_the_plain_branch_under_grad(dev):
    """`models.whisper.attention` sends an encoder-shaped bf16 call that
    needs a gradient to its plain branch (no launch), which gives q, k and
    v a gradient; the same call under no_grad launches the kernel."""
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = ((torch.randn(1, 2, 256, 64, generator=g, device=dev) * 0.5)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    before = encoder_attention.launches
    out = whisper.attention(q, k, v)
    assert encoder_attention.launches == before
    out.float().square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))
    with torch.no_grad():
        whisper.attention(q, k, v)
    assert encoder_attention.launches == before + 1


# bound of a bf16 card gradient against CPU f32 of the same (bf16) weights:
# relative L2 per leaf (the forward's bf16 roundings, ~2**-8 each, compound
# through two layers and the backward)
GRAD_REL = 0.05


def test_nll_loss_gradient_of_a_bf16_tree_on_the_card(dev):
    """`nll_loss` of a 2-layer whisper-small bf16 tree (full width) on the
    card: every leaf whose CPU f32 gradient is non-zero has a non-zero
    gradient, each within GRAD_REL (relative L2) of the CPU's. Before the
    guard, the encoder attention kernel cut the graph: the conv stem, the
    positions and the layers below its last call got zero or None."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.params import (
        init_params, named_leaves, tree_to)
    from openai_whisper_compression_tpu_torch.sensitivity.gradient import _batch_stats

    arch = ARCHS["small"].replace(encoder_layers=2, decoder_layers=2)
    params = init_params(arch, 0, torch.bfloat16, dev)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, 80, 3000)).astype(np.float32)
    toks = rng.integers(0, arch.vocab_size, (1, 8))
    labels = rng.integers(0, arch.vocab_size, (1, 8))

    def grads(tree, device):
        leaves = {n: t.detach().requires_grad_(True) for n, t in named_leaves(tree)}
        from openai_whisper_compression_tpu_torch.models.params import copy_tree, set_leaf
        t = copy_tree(tree)
        for n, leaf in leaves.items():
            set_leaf(t, n, leaf)
        loss = whisper.nll_loss(t, arch, torch.as_tensor(mel, device=device).to(
            next(iter(leaves.values())).dtype), torch.as_tensor(toks, device=device),
            torch.as_tensor(labels, device=device))
        gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return {n: (torch.zeros_like(l) if gr is None else gr).float().cpu()
                for (n, l), gr in zip(leaves.items(), gs)}

    before = encoder_attention.launches
    got = grads(params, dev)
    assert encoder_attention.launches == before   # the plain branch served the grad
    want = grads(tree_to(params, "cpu", torch.float32), "cpu")
    assert set(got) == set(want)
    for n, w in want.items():
        if bool(w.abs().sum() > 0):
            assert bool(got[n].abs().sum() > 0), f"{n}: zero on the card"
            rel = float((got[n] - w).norm() / w.norm())
            assert rel <= GRAD_REL, (n, rel)
    assert _batch_stats(params, arch, mel, toks, labels, 1.0)  # the scorer runs too


def test_gptq_solve_on_the_card(dev):
    """`gptq_solve` on the card against the port's CPU solve of the same
    weight and Hessian: scales bit-equal, at most 0.1% of the codes differ
    and those by one step (f32 updates summed on other units), the GPTQ
    objective within 1e-4 relative."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.quant.gptq import gptq_solve

    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal((768, 768)) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2048, 768)).astype(np.float32))
    h = x.t() @ x
    q_c, s_c, ok_c = gptq_solve(w, h, bits=4)
    q_g, s_g, ok_g = gptq_solve(w.to(dev), h.to(dev), bits=4)
    assert bool(ok_c) and bool(ok_g)
    assert torch.equal(s_g.cpu(), s_c)
    diff = (q_g.cpu().int() - q_c.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3

    def objective(q, s):
        e = w - q.float() * s
        return float(torch.einsum("ij,ik,kj->", e, h, e))

    o_c, o_g = objective(q_c, s_c), objective(q_g.cpu(), s_g.cpu())
    assert abs(o_g - o_c) <= 1e-4 * o_c, (o_g, o_c)


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
    # q at an offset that breaks 16-byte loads: read through an aligned copy
    off = torch.zeros(4 * 64 + 1, device=dev, dtype=bf)[1:].view(4, 64)
    off.copy_(torch.randn(4, 64, device=dev))
    full = torch.randn(4, 8, 64, device=dev).to(bf)
    assert torch.equal(decode_self_attention(off, full, full, 1),
                       decode_self_attention(off.clone(), full, full, 1))


# ---------------------------------------------------------------------------
# Lengths that token merging gives the kernels: the encoder at T = 750 or
# 500 (`encode(merge_at=)`), cross-KV of S = 750, 500 (pooled) or 1500 - r
# (ToMe), and short or odd spans where a cluster's blocks and warps share
# few chunks
# ---------------------------------------------------------------------------

MERGED_S = [750, 500, 1200, 33, 1]


@pytest.mark.parametrize("bh", [12, 36, 384])
@pytest.mark.parametrize("s_valid", MERGED_S)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_cross_attention_at_merged_lengths(dev, kind, s_valid, bh):
    """Both cross-attention kernels at S_pad = pad_cross_len(s_valid): the
    grouped one at 1, 3 and 5 slots, the one-query one (its cluster split
    by `one_query_splits`), each within one bf16 step of its plain
    version, finite, and blind to the padding."""
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        grouped_splits, one_query_splits, pad_cross_len)

    g = torch.Generator(device=dev).manual_seed(bh + s_valid)
    k, v, ks, vs = _cross_kv(dev, kind, bh, s_valid, bh * s_valid, torch.bfloat16)
    assert k.shape[2] == pad_cross_len(s_valid)
    assert 1 <= grouped_splits(bh, s_valid) <= max(1, -(-s_valid // 32))
    assert 1 <= one_query_splits(bh, s_valid) <= max(1, -(-s_valid // 64))
    outs = []
    for kq in (1, 3, 5):
        q = (torch.randn(bh, kq, 64, generator=g, device=dev) * 0.125).bfloat16()
        got = decode_cross_attention_grouped(q, k, v, ks, vs, s_valid)
        ref = decode_cross_attention_grouped_ref(q, k, v, ks, vs, s_valid)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=_tol(torch.bfloat16, float(ref.float().abs().max())),
                                   msg=lambda m: f"grouped, {kq} slots: {m}")
        outs.append((q, got))
    q1 = outs[0][0][:, 0, :].contiguous()
    got = decode_cross_attention(q1, k, v, ks, vs, s_valid)
    ref = decode_cross_attention_ref(q1, k, v, ks, vs, s_valid)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(torch.bfloat16, float(ref.float().abs().max())))
    for t in (k, v):
        t[:, :, s_valid:] = 99 if t.dtype == torch.int8 else 100.0
    if ks is not None:
        for t in (ks, vs):
            t[:, :, s_valid:] = float("inf")
    assert torch.equal(decode_cross_attention(q1, k, v, ks, vs, s_valid), got)
    for q, out in outs:
        assert torch.equal(decode_cross_attention_grouped(q, k, v, ks, vs, s_valid), out)


@pytest.mark.parametrize("b,h,t", [(32, 12, 750), (32, 12, 500), (3, 12, 750),
                                   (2, 16, 500), (1, 1, 749), (1, 2, 501)])
def test_encoder_attention_at_merged_lengths(dev, b, h, t):
    """The encoder attention after `merge_at` (T = 750 and 500, ragged last
    tiles of keys and of query rows): within one bf16 step of the plain
    version's largest output, finite, one launch."""
    q, k, v = _strided_qkv(dev, b, h, t, b * h + t)
    before = encoder_attention.launches
    got = encoder_attention(q, k, v)
    assert encoder_attention.launches == before + 1
    ref = encoder_attention_ref(q, k, v)
    assert got.shape == (b, h, t, 64) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(torch.bfloat16, float(ref.float().abs().max())))


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("b,s,h", [(32, 750, 12), (32, 500, 12), (3, 1200, 12),
                                   (64, 750, 16), (2, 33, 12)])
def test_transpose_quant_kv_at_merged_lengths(dev, dtype, b, s, h):
    """The cross-KV quantizer at the merged lengths (a partial last
    128-position tile): codes and scales bit-equal to the plain version's,
    on a fresh merged tensor as the model hands it over."""
    from openai_whisper_compression_tpu_torch.models.merge import pool_tokens, tome_merge

    g = torch.Generator(device=dev).manual_seed(b + s + h)
    x = (torch.randn(b, 2 * s, h * 64, generator=g, device=dev) * 3).to(dtype)
    x = pool_tokens(x, 2) if s % 3 else tome_merge(x, s)
    assert x.shape == (b, s, h * 64) and x.is_contiguous()
    before = transpose_quant_kv.launches
    q, sc = transpose_quant_kv(x, h)
    assert transpose_quant_kv.launches == before + 1
    q_ref, sc_ref = transpose_quant_kv_ref(x, h)
    assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)


@pytest.mark.parametrize("switches", [
    {"cross_kv_pool": 2, "kv_int8": True, "cross_kv_int8": True},
    {"cross_kv_pool": 3, "cross_kv_int4": True},
    {"cross_kv_merge": 300}, {"cross_kv_merge": 750, "cross_kv_int8": True}],
    ids=["pool2-ckv8", "pool3-ckv4", "tome300", "tome750-ckv8"])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_merge_pool_path_on_the_card(dev, switches, batch):
    """The decode after pooling or merging, through the kernels at the
    merged lengths (the one-query kernel at batch 1 and 3, B*H % 16 != 0):
    cross-KV as long as the merge leaves it, first-step logits within 2**-5
    relative L2 of the same tree and inputs in f32 on the CPU, greedy tokens
    in range, each kernel of the path launched."""
    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_to
    from openai_whisper_compression_tpu_torch.ops.cross_attention import (
        decode_cross_attention as one_query)

    arch = ARCHS["tiny"].replace(d_model=128, encoder_heads=2, decoder_heads=2,
                                 ffn_dim=256, encoder_layers=1, decoder_layers=2)
    params = init_params(arch, 0, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(batch)
    enc = torch.randn(batch, 1500, 128, generator=g, device=dev).bfloat16()
    cfg = DecodeConfig(max_new_tokens=5, **switches)
    kvs = decode.cross_kvs_for(params, arch, enc, cfg)
    s = (1500 - switches["cross_kv_merge"] if "cross_kv_merge" in switches
         else -(-1500 // switches["cross_kv_pool"]))
    assert kvs[0].valid_len == s
    step = ("int4" if switches.get("cross_kv_int4") else
            "int8" if switches.get("cross_kv_int8") else "")
    attr = "launches" + ("_" + step if step else "")
    before = getattr(one_query, attr)
    got = decode.first_step_logits(params, arch, enc, cfg).float().cpu()
    ref = decode.first_step_logits(tree_to(params, "cpu", torch.float32), arch,
                                   enc.float().cpu(), cfg)
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= 2 ** -5, rel
    assert (getattr(one_query, attr) > before) == ((batch * 2) % 16 != 0)
    tokens, lengths = decode.greedy_decode(params, arch, enc, cfg)
    assert int(tokens.max()) < arch.vocab_size and bool((lengths >= 4).all())


@pytest.mark.parametrize("switches", [{}, {"kv_int8": True, "cross_kv_int8": True}],
                         ids=["bf16", "kv8-ckv8"])
@pytest.mark.parametrize("batch", [3, 16])
def test_speculative_path_on_the_card(dev, switches, batch):
    """The callers that bring caches of other lengths to the decode kernels
    (`models/speculative.py`): a verify window at an offset over a cache of
    13 rows (no multiple of 64) within 2**-5 relative L2 of stepping the
    same tokens through the fused step on the card; `speculative_decode`
    with a layer-dropped self draft over caches of max_len + gamma + 1 = 69
    rows and `verified_greedy_decode` with a left-padded prompt, each
    launching the cache-update kernels (with `start` for the prompt) and
    the cross-attention kernels, with tokens in range and every row its
    full length (EOT suppressed)."""
    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.models import cache as kv_cache
    from openai_whisper_compression_tpu_torch.models import decode, speculative
    from openai_whisper_compression_tpu_torch.models.params import init_params

    arch = ARCHS["tiny"].replace(d_model=128, encoder_heads=2, decoder_heads=2,
                                 ffn_dim=256, encoder_layers=1, decoder_layers=2)
    params = init_params(arch, 0, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(batch)
    enc = torch.randn(batch, 1500, 128, generator=g, device=dev).bfloat16()
    cfg = DecodeConfig(max_new_tokens=12, suppress_tokens=(arch.eos_token_id,),
                       **switches)
    int8 = bool(switches)
    update = (decode_self_attention_update_int8 if int8 else decode_self_attention_update)

    kvs = decode.cross_kvs_for(params, arch, enc, cfg)
    toks = torch.randint(0, 50000, (batch, 8), generator=g, device=dev)
    caches = [kv_cache.init_cache(params, arch, batch, 13, dtype=torch.bfloat16,
                                  device=dev, int8=int8) for _ in range(2)]
    with torch.inference_mode():
        steps = [decode.decoder_step(params, arch, toks[:, i], i, caches[0], kvs)
                 for i in range(8)]
        for i in range(3):
            decode.decoder_step(params, arch, toks[:, i], i, caches[1], kvs)
        window = speculative.verify_window(params, arch, toks[:, 3:], 3, caches[1], kvs)
    ref = torch.stack(steps[3:], dim=1).float()
    rel = float((window.float() - ref).norm() / ref.norm())
    assert rel <= 2 ** -5, rel

    draft, arch_d = speculative.self_speculative_draft(params, arch, keep_decoder=1)
    before = update.launches
    with torch.inference_mode():
        tokens, lengths, rounds = speculative.speculative_decode(
            params, arch, draft, arch_d, enc, enc, cfg, gamma=4)
    assert update.launches > before and rounds >= 1
    assert int(tokens.max()) < arch.vocab_size and bool((lengths == 4 + 12).all())

    prompt = torch.randint(0, 50000, (batch, 8), generator=g, device=dev)
    plen = torch.tensor([8, 3, 5] * (batch // 3) + [8] * (batch % 3), device=dev)
    with torch.inference_mode():
        ref_t, ref_l = decode.greedy_decode(params, arch, enc, cfg, prompt_tokens=prompt,
                                            prompt_lens=plen)
        before = update.launches_start
        got_t, got_l, n_acc = speculative.verified_greedy_decode(
            params, arch, enc, cfg, ref_t[:, 12:24], torch.full((batch,), 12, device=dev),
            prompt_tokens=prompt, prompt_lens=plen)
    assert int(got_t.max()) < arch.vocab_size and torch.equal(got_l, ref_l)
    assert bool((n_acc >= 0).all()) and bool((n_acc <= 12).all())
    # a row whose every draft token was accepted steps no further
    assert (update.launches_start > before) == bool((n_acc < 12).any())


def _serving_arch_params(dev):
    """A narrow two-layer whisper (d_model 128, 2 heads of 64) with int8
    weights and fused qkv, bf16, on the card: the serving tests' model."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    arch = ARCHS["tiny"].replace(d_model=128, encoder_heads=2, decoder_heads=2,
                                 ffn_dim=256, encoder_layers=1, decoder_layers=2)
    return arch, fuse_qkv(quantize_params(init_params(arch, 0, torch.bfloat16, dev), "int8"))


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("kv_int8", [True, False], ids=["kv8", "kv-bf16"])
def test_continuous_batching_step_on_the_card(dev, kv_int8):
    """Continuous batching's caller of the decode kernels: 8 slots (16
    (batch, head) rows, the grouped cross-attention) over a 128-row window,
    int8 cross-KV written by `admit` and `admit_from_stage` row copies, the
    cache updates with a per-slot `start`: at positions in both 64-position
    passes, with `start` in the second pass, then after a rebase. Every
    kernel call is held against its plain version on its inputs (caches
    bit for bit); the staged rows land in their slots bit for bit."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.models import decode
    from openai_whisper_compression_tpu_torch.models.continuous import make_cb_fns

    cs = _chip_smoke()
    arch, params = _serving_arch_params(dev)
    cfg = DecodeConfig(max_new_tokens=64, suppress_tokens=(arch.eos_token_id,),
                       kv_int8=kv_int8, cross_kv_int8=True)
    plan, fns = make_cb_fns(arch, cfg, 8, chunk=8, admit_lanes=4, fast_gelu=True, device=dev)
    assert plan.cache_len == 128
    g = torch.Generator(device=dev).manual_seed(3)
    wav = torch.randn(8, plan.n_samples, generator=g, device=dev) * 0.1
    lanes, mask, caps = np.arange(4), np.ones(4, bool), np.full(4, 64)
    name = "decode_self_attention_update_int8" if kv_int8 else "decode_self_attention_update"
    seen, phase = [], ["admit"]
    shapes: dict = {}
    with cs.checked_kernel_calls(shapes) as held:
        inner = getattr(decode, name)

        def recorded(*a, start=None):
            seen.append((phase[0], int(a[-1]), int(start.min()), int(start.max())))
            return inner(*a, start=start)

        with cs.patched((decode, name, recorded)):
            state = fns["init"](params)
            state = fns["admit"](params, state, wav[:4], lanes, mask, caps)
            for _ in range(5):
                state, _ = fns["chunk"](params, state)
            state = fns["admit"](params, state, wav[4:], lanes + 4, mask, caps)
            for _ in range(4):
                state, _ = fns["chunk"](params, state)
            assert state["pos"] == 72 and state["finished"][:4].all()
            stage = fns["encode_stage"](params, wav[:4])
            state = fns["admit_from_stage"](state, stage, lanes, lanes, mask, caps)
            h = state["cross"][0].k_t.shape[0] // 8
            for kv, skv in zip(state["cross"], stage):
                assert torch.equal(kv.k_t[: 4 * h], skv.k_t[: 4 * h])
                assert torch.equal(kv.v_scale[: 4 * h], skv.v_scale[: 4 * h])
            phase[0] = "pass2"
            for _ in range(2):
                state, _ = fns["chunk"](params, state)
            state = fns["rebase"](state, 40)
            assert state["pos"] == 48 and state["start"].tolist() == [32] * 4 + [0] * 4
            phase[0] = "rebased"
            for _ in range(3):
                state, sync = fns["chunk"](params, state)
    assert any(p < 64 for _, p, _, _ in seen)
    assert any(ph == "pass2" and p >= 64 and hi >= 64 for ph, p, _, hi in seen)
    assert any(ph == "rebased" and p >= 64 for ph, p, _, _ in seen)
    assert held[name] == len(seen) == 2 * (9 * 8 + 2 * 8 + 3 * 8)
    assert held["decode_cross_attention_grouped"] == len(seen)
    assert held["int8_matmul"] == 6 * len(seen) and held["encoder_attention"] == 4
    tokens = sync[1 + 16:].reshape(8, plan.cache_len)
    assert int(tokens.max()) < arch.vocab_size


def test_streaming_pool_at_partial_occupancy_on_the_card(dev):
    """The streaming pool's caller: 2 sessions in a 4-row pool (the others
    padding lanes), timestamps on, int8 caches: the mirror rows equal the
    host windows bit for bit, every kernel call of the batched step (mel,
    encoder attention, cross-KV quantizer, the verify window's grouped
    calls, the steps' one-query cross-attention and cache updates with a
    prompt's `start`) held against its plain version, and the partials
    well-formed."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.streaming import StreamingPool

    cs = _chip_smoke()
    arch, params = _serving_arch_params(dev)
    cfg = DecodeConfig(max_new_tokens=8, notimestamps=False, kv_int8=True, cross_kv_int8=True)
    pool = StreamingPool(params, arch, default_tokenizer(arch), cfg, max_streams=4,
                         min_step_s=0.5, prompt_window=16, device=dev)
    rng = np.random.default_rng(0)
    shapes: dict = {}
    with cs.checked_kernel_calls(shapes) as held:
        for sid in "ab":
            pool.open(sid)
        for _ in range(3):
            for sid in "ab":
                pool.feed(sid, (rng.standard_normal(8000) * 0.1).astype(np.float32))
            out = pool.tick()
            mirror = pool._mirror.cpu().numpy()
            for sid in "ab":
                win = pool.sessions[sid]._window()
                r = pool._row_of[sid]
                assert np.array_equal(mirror[r, : len(win)], win)
                assert not mirror[r, len(win):].any()
        finals = [pool.close(sid) for sid in "ab"]
    assert pool.stats()["mean_batch_occupancy"] == 0.5
    assert held["encoder_attention"] >= 3 and held["decode_cross_attention_grouped"] > 0
    assert held["decode_self_attention_update_int8"] > 0
    assert all(isinstance(o["committed"], str) for o in list(out.values()) + finals)


def test_serving_bucket_of_8_on_the_card(dev):
    """A partial batch of 3 requests at batch size 32 rides the 8-row
    bucket; every kernel call held against its plain version; each
    result's tokens equal a direct `make_transcribe_fn` call on the same
    8 loader rows; the service closes and its worker ends."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.evaluation.tokenizer import default_tokenizer
    from openai_whisper_compression_tpu_torch.serving import TranscriptionService

    cs = _chip_smoke()
    arch, params = _serving_arch_params(dev)
    cfg = DecodeConfig(max_new_tokens=6, suppress_tokens=(arch.eos_token_id,),
                       kv_int8=True, cross_kv_int8=True)
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    svc = TranscriptionService(params, arch, default_tokenizer(arch), cfg, batch_size=32,
                               max_wait_ms=500, transcribe_fn=fn, transfer="int16",
                               device=dev)
    wires = []
    real = svc._fn

    def recorded(p, wire):
        wires.append(np.array(wire))
        return real(p, wire)

    svc._fn = recorded
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(16000 * (k + 2)) * 0.1).astype(np.float32) for k in range(3)]
    shapes: dict = {}
    try:
        with cs.checked_kernel_calls(shapes) as held:
            res = [f.result(timeout=300) for f in [svc.submit(w) for w in wavs]]
    finally:
        svc.close(timeout=300)
    assert not svc._worker.is_alive()
    assert [w.shape for w in wires] == [(8, 480000)]
    assert held["encoder_attention"] == 1 and held["decode_cross_attention_grouped"] > 0
    want = np.zeros((8, 480000), np.int16)
    for i, w in enumerate(wavs):
        want[i, : len(w)] = np.clip(np.round(w * 32768.0), -32768, 32767)
    assert np.array_equal(wires[0], want)
    toks, lens = fn(params, torch.from_numpy(want).to(dev).float() * (1.0 / 32768.0))
    toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
    for i, r in enumerate(res):
        ids = toks[i, 4: lens[i]]
        assert r["tokens"] == ids[ids != arch.eos_token_id].tolist()


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", ["large-v3", "small"])
def test_pruned_model_decodes_on_the_card(dev, model, batch):
    """Two layers at the model's width after `prune_heads_by_l1(0.5)` and
    `shrink_ffn(0.3)` (whisper-small keeps 922 FFN units, a ragged width;
    large-v3 1536), int8 weights, fused qkv, int8 self-KV and cross-KV:
    every kernel call held against its plain version, no wrapper raising;
    the pruned head count picks the cross-attention (batch 1: B·H of 10 or
    6, the one-query kernel; batch 8: 80 or 48, the grouped one)."""
    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.prune.structured import (
        prune_heads_by_l1, shrink_ffn)
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params

    cs = _chip_smoke()
    arch = ARCHS[model].replace(encoder_layers=2, decoder_layers=2)
    params = prune_heads_by_l1(init_params(arch, 0, torch.bfloat16, dev), arch, 0.5)
    for comp in ("encoder", "decoder"):
        for li in range(2):
            params = shrink_ffn(params, comp, li, 0.3)
    params = fuse_qkv(quantize_params(params, "int8"))
    ffn, heads = round(0.3 * arch.ffn_dim), arch.decoder_heads // 2
    assert params["decoder"]["layers"][0]["fc1"]["w"].shape == (arch.d_model, ffn)
    cfg = DecodeConfig(max_new_tokens=3, suppress_tokens=(arch.eos_token_id,),
                       kv_int8=True, cross_kv_int8=True)
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(batch)
    wav = torch.randn(batch, 480_000, generator=g, device=dev) * 0.1
    shapes: dict = {}
    with cs.checked_kernel_calls(shapes) as held:
        toks, lens = fn(params, wav)
    assert toks.shape[0] == batch and bool((lens == 4 + 3).all())
    assert held["encoder_attention"] == 2 and held["transpose_quant_kv"] == 2 * 2  # K, V
    assert any(k[0] == "int8_matmul" and k[-1] == ffn for k in shapes)
    assert any(k[0] == "int8_matmul" and k[2] == ffn for k in shapes)
    assert any(k[0] == "encoder_attention" and k[1] == heads for k in shapes)
    if batch * heads % 16:
        assert held["decode_cross_attention"] == 2 * 3   # layers x steps
    else:
        assert "decode_cross_attention" not in held
    assert held["decode_cross_attention_grouped"] > 0


def _small2(dev, dtype=torch.bfloat16):
    """whisper-small at full width, 2 encoder and 2 decoder layers, seeded."""
    from openai_whisper_compression_tpu_torch.config import ARCHS
    from openai_whisper_compression_tpu_torch.models.params import init_params

    arch = ARCHS["small"].replace(encoder_layers=2, decoder_layers=2)
    return arch, init_params(arch, 0, dtype, dev)


@pytest.mark.parametrize("fmt", ["npz", "gzip", "sparse_zip"])
def test_storage_roundtrip_decodes_on_the_card(dev, tmp_path, fmt):
    """A whisper-small int8 tree (2 layers of full width, fused qkv) saved
    from the card and read back onto it through each format: every leaf
    bit-equal and contiguous on the card, and a decode with every kernel
    call held (int8 caches, 4 tokens, EOT suppressed) gives the in-memory
    tree's tokens."""
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.fuse import fuse_qkv
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params
    from openai_whisper_compression_tpu_torch.storage import formats

    cs = _chip_smoke()
    arch, params = _small2(dev)
    params = fuse_qkv(quantize_params(params, "int8"))
    cfg = DecodeConfig(max_new_tokens=4, suppress_tokens=(arch.eos_token_id,),
                       kv_int8=True, cross_kv_int8=True)
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, fast_gelu=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    wav = torch.randn(8, 480_000, generator=g, device=dev) * 0.1
    want, _ = fn(params, wav)
    save, load = formats.FORMATS[fmt]
    save(params, str(tmp_path / f"m.{fmt}"))
    loaded = load(str(tmp_path / f"m.{fmt}"), device=dev)
    assert formats.trees_equal(loaded, params) == []
    assert cs.contiguous_on_card(loaded)
    shapes: dict = {}
    with cs.checked_kernel_calls(shapes, mel=True) as held:
        got, lens = fn(loaded, wav)
    assert torch.equal(got, want) and bool((lens == 4 + 4).all())
    assert held["int8_matmul"] > 0 and held["decode_self_attention_update_int8"] > 0


def test_bf16_safetensors_snapshot_feeds_every_kernel(dev, tmp_path):
    """A bf16 safetensors snapshot (2 shards, config.json) of whisper-small
    at 2 layers of full width, loaded onto the card by `load_model(hf=)`:
    every leaf contiguous on the card and bit-equal to the tree written; the
    tree, and its int8, int4, NF4, HQQ and w8a8 quantizations, decode with
    every kernel call held (bf16 and int8 caches, batch 8 and batch 1), so
    that every kernel wrapper takes what the loader gives it."""
    import json

    from openai_whisper_compression_tpu_torch import load_model
    from openai_whisper_compression_tpu_torch.config import DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import make_transcribe_fn
    from openai_whisper_compression_tpu_torch.models.convert import (to_hf_state_dict,
                                                                     write_safetensors)
    from openai_whisper_compression_tpu_torch.quant.api import quantize_params
    from openai_whisper_compression_tpu_torch.storage import formats

    cs = _chip_smoke()
    arch, params = _small2(dev)
    sd = to_hf_state_dict(params)
    keys = list(sd)
    for i, ks in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        write_safetensors({k: sd[k] for k in ks}, str(tmp_path / f"model-{i}.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: f"model-{i}.safetensors" for i, ks in enumerate(
            (keys[: len(keys) // 2], keys[len(keys) // 2:])) for k in ks}}, f)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"vocab_size": arch.vocab_size, "num_mel_bins": arch.num_mel_bins,
                   "d_model": arch.d_model, "encoder_layers": 2,
                   "encoder_attention_heads": arch.encoder_heads, "decoder_layers": 2,
                   "decoder_attention_heads": arch.decoder_heads,
                   "encoder_ffn_dim": arch.ffn_dim, "decoder_ffn_dim": arch.ffn_dim,
                   "max_source_positions": arch.max_source_positions,
                   "max_target_positions": arch.max_target_positions,
                   "eos_token_id": arch.eos_token_id,
                   "decoder_start_token_id": arch.decoder_start_token_id}, f)
    loaded, got = load_model(hf=str(tmp_path), dtype=torch.bfloat16, device=dev)
    assert (got.d_model, got.decoder_layers, got.decoder_heads) == (768, 2, 12)
    assert formats.trees_equal(loaded, params) == []
    assert cs.contiguous_on_card(loaded)
    g = torch.Generator(device=dev).manual_seed(6)
    wav = torch.randn(8, 480_000, generator=g, device=dev) * 0.1
    kv8 = dict(kv_int8=True, cross_kv_int8=True)
    held_all: dict = {}
    for method, switches, rows in [(None, {}, 8), (None, kv8, 8), (None, kv8, 1),
                                   ("int8", kv8, 8), ("int4", kv8, 8), ("nf4", kv8, 8),
                                   ("hqq_int4", kv8, 8), ("pytorch_dynamic_int8", kv8, 8)]:
        tree = loaded if method is None else quantize_params(loaded, method)
        cfg = DecodeConfig(max_new_tokens=3, suppress_tokens=(got.eos_token_id,), **switches)
        fn = make_transcribe_fn(got, cfg, fast_mel=True, fast_gelu=True, device=dev)
        with cs.checked_kernel_calls({}, mel=True) as held:
            toks, lens = fn(tree, wav[:rows])
        assert bool((lens == 4 + 3).all())
        for k, v in held.items():
            held_all[k] = held_all.get(k, 0) + v
    assert {"log_mel_cuda", "encoder_attention", "transpose_quant_kv",
            "decode_cross_attention_grouped", "decode_cross_attention",
            "decode_self_attention_update", "decode_self_attention_update_int8",
            "int8_matmul", "int4_matmul", "nf4_matmul", "w8a8_matmul"} <= set(held_all)


# The tensor-parallel decoder's shard-local shapes (parallel/tp_forward.py at
# tp = 2 on whisper-small): 6 of 12 heads; the int8 matmul on column splits
# (q/k/v and cross q: N = 384; fc1: N = 1536) and row splits (o: K = 384;
# fc2: K = 1536) at decode M = 32 and 3.
TP_MATMULS = [(m, k, n) for m in (32, 3)
              for k, n in ((768, 384), (384, 768), (768, 1536), (1536, 768))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=_IDS.get)
@pytest.mark.parametrize("m,k,n", TP_MATMULS)
def test_int8_matmul_at_tp_shard_shapes(dev, dtype, m, k, n):
    test_int8_matmul(dev, dtype, m, k, n)


@pytest.mark.parametrize("b", [2, 32])
def test_encoder_attention_on_tp_local_heads(dev, b):
    test_encoder_attention(dev, b, 6, 1500)


@pytest.mark.parametrize("b", [3, 32])
def test_transpose_quant_kv_on_tp_local_heads(dev, b):
    test_transpose_quant_kv(dev, torch.bfloat16, b, 1500, 6)


@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_cross_attention_on_tp_local_heads(dev, bits):
    """32 rows x 6 local heads = 192 (batch, head) rows, one slot."""
    test_cross_attention_grouped_quantized(dev, bits, 32 * 6, 1, 1500, torch.bfloat16)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_one_query_cross_attention_on_tp_local_heads(dev, kind):
    """3 rows x 6 local heads = 18 rows, no multiple of 16: the one-query
    kernel the TP decoder takes there."""
    test_cross_attention_one_query(dev, kind, 3 * 6, 1500, torch.bfloat16)


# ---------------------------------------------------------------------------
# Head dims other than 64 (every attention kernel is a template on it),
# strided and offset inputs, long caches.

OTHER_DIMS = [16, 32, 128]


def _kv_of_dim(dev, kind, bh, dh, s_valid, dtype, seed):
    """(k_t, v_t, k_scale, v_scale) of head dim dh: K/V in q's type, or int8
    / split-half int4 quantized by the plain quantizers (positions >= s_valid
    quantized zeros)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s_pad = -(-s_valid // 128) * 128
    if kind == "fp":
        return (*(torch.randn(bh, dh, s_pad, generator=g, device=dev).to(dtype)
                  for _ in range(2)), None, None)
    out = []
    for _ in range(2):
        x = torch.randn(1, s_pad, bh * dh, generator=g, device=dev)
        x[:, s_valid:] = 0
        data, scale = transpose_quant_kv_ref(x, bh)
        if kind == "int4":
            data, scale = whisper._quant_kv4_t(data.float() * scale)
        out.append((data, scale))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _counter_of(kind, dtype):
    return {"fp": "launches" + _COUNTER[dtype], "int8": "launches_int8",
            "int4": "launches_int4"}[kind]


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", OTHER_DIMS)
def test_head_dims_cross_attention_grouped(dev, dh, dtype, kind):
    """The grouped kernel at head dims 16, 32 and 128 (split-half int4 at
    16: 8 stored rows), every storage kind under q in each type, at 1, 5 and
    8 slots over 24 and 192 rows, s_valid 1500 and 100: within one step of
    q's type of the plain version's largest output, one launch a call,
    poisoned padding changing no output bit."""
    for bh, s_valid in ((24, 1500), (192, 100)):
        k, v, ks, vs = _kv_of_dim(dev, kind, bh, dh, s_valid, dtype, bh + dh)
        g = torch.Generator(device=dev).manual_seed(dh + s_valid)
        for kq in (1, 5, 8):
            q = (torch.randn(bh, kq, dh, generator=g, device=dev) * dh ** -0.5).to(dtype)
            attr = _counter_of(kind, dtype) + ("_wide" if kq > 4 else "")
            before = getattr(decode_cross_attention_grouped, attr)
            got = decode_cross_attention_grouped(q, k, v, ks, vs, s_valid)
            assert getattr(decode_cross_attention_grouped, attr) == before + 1
            ref = decode_cross_attention_grouped_ref(q, k, v, ks, vs, s_valid)
            assert got.shape == q.shape and got.dtype == dtype
            torch.testing.assert_close(
                got.float(), ref.float(), rtol=0,
                atol=_tol(dtype, float(ref.float().abs().max())),
                msg=lambda m: f"BH {bh}, {kq} slots: {m}")
        k[:, :, s_valid:] = 99 if kind != "fp" else 100.0
        v[:, :, s_valid:] = -77 if kind == "fp" else 99
        if ks is not None:
            ks[:, :, s_valid:] = float("inf")
            vs[:, :, s_valid:] = float("inf")
        assert torch.equal(decode_cross_attention_grouped(q, k, v, ks, vs, s_valid), got)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", OTHER_DIMS)
def test_head_dims_cross_attention_one_query(dev, dh, dtype, kind):
    """The one-query kernel at head dims 16, 32 and 128 (at 128 it loads a
    tile at a time), every storage kind under q in each type, at 12 and 36
    rows, s_valid 1500 and 129: within one step of q's type of the plain
    version and of the grouped kernel at one slot; one launch a call."""
    for bh, s_valid in ((12, 1500), (36, 129)):
        k, v, ks, vs = _kv_of_dim(dev, kind, bh, dh, s_valid, dtype, 3 * bh + dh)
        g = torch.Generator(device=dev).manual_seed(bh * dh)
        q = (torch.randn(bh, dh, generator=g, device=dev) * dh ** -0.5).to(dtype)
        counter = _counter_of(kind, dtype)
        before = getattr(decode_cross_attention, counter)
        got = decode_cross_attention(q, k, v, ks, vs, s_valid)
        assert getattr(decode_cross_attention, counter) == before + 1
        ref = decode_cross_attention_ref(q, k, v, ks, vs, s_valid)
        grouped = decode_cross_attention_grouped(q[:, None, :].contiguous(), k, v, ks, vs,
                                                 s_valid)[:, 0, :]
        assert got.shape == (bh, dh) and got.dtype == dtype
        tol = _tol(dtype, float(ref.float().abs().max()))
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol)
        torch.testing.assert_close(got.float(), grouped.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", OTHER_DIMS)
@pytest.mark.parametrize("b,s,h", [(2, 1500, 0), (1, 129, 3), (3, 64, 4)])
def test_head_dims_transpose_quant_kv(dev, b, s, h, dh, dtype):
    """The cross-KV quantizer at head dims 16, 32 and 128 (h = 0: a width of
    768, the heads it holds at dh): codes and scales bit-equal to the plain
    version, one launch a call."""
    h = h or 768 // dh
    g = torch.Generator(device=dev).manual_seed(b * s + h + dh)
    x = (torch.randn(b, s, h * dh, generator=g, device=dev) * 0.4).to(dtype)
    before = transpose_quant_kv.launches
    q, sc = transpose_quant_kv(x, h)
    assert transpose_quant_kv.launches == before + 1
    q_ref, sc_ref = transpose_quant_kv_ref(x, h)
    assert q.shape == (b * h, dh, -(-s // 128) * 128)
    assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)


def _strided_qkv_of_dim(dev, b, h, t, dh, seed):
    """(B, H, T, dh) bf16 views of one fused (B, T, 3 H dh) projection."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fused = torch.randn(b, t, 3 * h * dh, generator=g, device=dev).bfloat16()
    return [whisper.split_heads(fused[..., i * h * dh: (i + 1) * h * dh], h)
            for i in range(3)]


@pytest.mark.parametrize("dh", OTHER_DIMS)
@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 129), (2, 4, 1500), (1, 2, 257)])
def test_head_dims_encoder_attention(dev, b, h, t, dh):
    """The encoder attention at head dims 16 and 32 (32- and 64-byte
    swizzled tiles) and 128 (two 64-dim halves, 64 keys a stage), on views
    of one fused projection, within one bf16 step of the plain version's
    largest output (q scaled by dh**-0.5 in the kernel); the output's memory
    is (B, T, H, dh); contiguous inputs give the same bits."""
    q, k, v = _strided_qkv_of_dim(dev, b, h, t, dh, b + h + t + dh)
    before = encoder_attention.launches
    got = encoder_attention(q, k, v)
    assert encoder_attention.launches == before + 1
    ref = encoder_attention_ref(q, k, v)
    assert got.shape == (b, h, t, dh) and got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(torch.bfloat16, float(ref.float().abs().max())))
    assert torch.equal(encoder_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous()), got)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", OTHER_DIMS)
def test_head_dims_self_attention(dev, dh, dtype, with_start, int8):
    """Both cache updates and the read-only attention at head dims 16, 32
    and 128 (the f32 fp update at 128 loads V after the scores), at 13 and
    36 rows, pos 0, 63 and 300 of a 448-row cache: caches and scales
    bit-equal to the plain version's, the output within one step of q's
    type, the read-only kernel on the written cache bit-equal to the
    update's output; each launch counted."""
    g = torch.Generator(device=dev).manual_seed(dh + int8)
    for bh, s, pos in ((13, 64, 0), (36, 64, 63), (36, 448, 300)):
        q = (torch.randn(bh, dh, generator=g, device=dev) * dh ** -0.5).to(dtype)
        kn, vn = (torch.randn(2, bh, dh, generator=g, device=dev) * 2).to(dtype)
        if int8:
            kc, vc = torch.randint(-127, 128, (2, bh, s, dh), generator=g, device=dev,
                                   dtype=torch.int8)
            ks, vs = torch.rand(2, bh, s, generator=g, device=dev) * 0.03 + 1e-3
            bufs = [kc, vc, ks, vs]
            upd, upd_ref = decode_self_attention_update_int8, decode_self_attention_update_int8_ref
            counter, read = "launches", "launches_int8"
            scales = {"k_scale": ks, "v_scale": vs}
        else:
            bufs = [torch.randn(bh, s, dh, generator=g, device=dev).to(dtype)
                    for _ in range(2)]
            upd, upd_ref = decode_self_attention_update, decode_self_attention_update_ref
            counter = read = "launches" + _COUNTER[dtype]
            scales = {}
        start = _mixed_start(dev, bh, pos) if with_start else None
        suffix = "_start" if with_start else ""
        refs = [t.clone() for t in bufs]
        before = getattr(upd, counter + suffix)
        got = upd(q, kn, vn, *bufs, pos, start=start)
        assert getattr(upd, counter + suffix) == before + 1
        ref = upd_ref(q, kn, vn, *refs, pos, start=start)
        assert all(torch.equal(a, r) for a, r in zip(bufs, refs)), (bh, s, pos)
        assert got.shape == (bh, dh) and got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=_tol(dtype, float(ref.float().abs().max())),
                                   msg=lambda m: f"BH {bh} S {s} pos {pos}: {m}")
        before = getattr(decode_self_attention, read + suffix)
        again = decode_self_attention(q, bufs[0], bufs[1], pos, start=start, **scales)
        assert getattr(decode_self_attention, read + suffix) == before + 1
        assert torch.equal(again, got)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dh", [16, 64, 512])
def test_self_attention_long_cache(dev, dh, int8):
    """A 16384-row cache at pos 16383 and, with a mixed start, 9000 (the cap
    of 12288 rows is gone), also at head dim 512 (the WIDE body): caches
    bit-equal, output within one bf16 step."""
    g = torch.Generator(device=dev).manual_seed(dh)
    bh, s = 8, 16384
    q = (torch.randn(bh, dh, generator=g, device=dev) * dh ** -0.5).bfloat16()
    kn, vn = (torch.randn(2, bh, dh, generator=g, device=dev) * 2).bfloat16()
    if int8:
        bufs = [*torch.randint(-127, 128, (2, bh, s, dh), generator=g, device=dev,
                               dtype=torch.int8),
                *(torch.rand(2, bh, s, generator=g, device=dev) * 0.03 + 1e-3)]
        upd, upd_ref = decode_self_attention_update_int8, decode_self_attention_update_int8_ref
    else:
        bufs = [torch.randn(bh, s, dh, generator=g, device=dev).bfloat16() for _ in range(2)]
        upd, upd_ref = decode_self_attention_update, decode_self_attention_update_ref
    for pos, start in ((s - 1, None), (9000, _mixed_start(dev, bh, 9000))):
        refs = [t.clone() for t in bufs]
        got = upd(q, kn, vn, *bufs, pos, start=start)
        ref = upd_ref(q, kn, vn, *refs, pos, start=start)
        assert all(torch.equal(a, r) for a, r in zip(bufs, refs))
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=_tol(torch.bfloat16, float(ref.float().abs().max())))


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dh", [16, 64])
def test_strided_cross_attention_inputs(dev, dh, kind):
    """q as a slice of a fused (BH, 3 dh) projection, K/V and their scales at
    storage offsets that break 16-byte loads: both cross-attention kernels
    read them through aligned copies, one launch a call, and return the bits
    they return on contiguous copies."""
    bh, s_valid = 24, 1500
    k, v, ks, vs = _kv_of_dim(dev, kind, bh, dh, s_valid, torch.bfloat16, dh)
    g = torch.Generator(device=dev).manual_seed(dh + 1)
    fused = torch.randn(bh, 3 * dh, generator=g, device=dev).bfloat16()
    q = fused[:, dh: 2 * dh]

    def offset(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    kv = [offset(t) if t is not None else None for t in (k, v, ks, vs)]
    assert kv[0].data_ptr() % 16 != 0 and not q.is_contiguous()
    counter = _counter_of(kind, torch.bfloat16)
    for fn, qq in ((decode_cross_attention, q),
                   (decode_cross_attention_grouped, fused.view(bh, 3, dh)[:, 1:])):
        before = getattr(fn, counter)
        got = fn(qq, *kv, s_valid)
        assert getattr(fn, counter) == before + 1
        assert torch.equal(got, fn(qq.contiguous(), k, v, ks, vs, s_valid))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dh", [16, 64])
def test_strided_self_attention_caches(dev, dh, int8):
    """q and the fresh rows as slices of a fused (BH, 3 dh) projection; the
    caches (and int8 scales) as prefix views of longer buffers, then at a
    storage offset that breaks 16-byte loads: the update writes row pos of
    the caller's view (through a contiguous copy), leaves the buffer past
    the view untouched, and returns what it returns on contiguous caches,
    bit for bit; the read-only kernel on the views equals it too."""
    g = torch.Generator(device=dev).manual_seed(dh + 2 * int8)
    bh, s, pos, extra = 24, 64, 40, 16
    fused = (torch.randn(bh, 3 * dh, generator=g, device=dev) * 0.5).bfloat16()
    q, kn, vn = (fused[:, i * dh: (i + 1) * dh] for i in range(3))
    if int8:
        big = [*torch.randint(-127, 128, (2, bh, s + extra, dh), generator=g, device=dev,
                              dtype=torch.int8),
               *(torch.rand(2, bh, s + extra, generator=g, device=dev) * 0.03 + 1e-3)]
        upd = decode_self_attention_update_int8
    else:
        big = [torch.randn(bh, s + extra, dh, generator=g, device=dev).bfloat16()
               for _ in range(2)]
        upd = decode_self_attention_update
    views = [t[:, :s] for t in big]
    flat = [torch.empty(t.numel() + 1, dtype=t.dtype, device=dev) for t in views]
    offs = [f[1:].view(t.shape).copy_(t) for f, t in zip(flat, views)]
    plain = [t.contiguous() for t in views]
    tails = [t[:, s:].clone() for t in big]
    assert not views[0].is_contiguous() and offs[0].data_ptr() % 16 != 0
    want = upd(q.contiguous(), kn.contiguous(), vn.contiguous(), *plain, pos)
    for bufs in (views, offs):
        got = upd(q, kn, vn, *bufs, pos)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(bufs, plain))
        scales = {"k_scale": bufs[2], "v_scale": bufs[3]} if int8 else {}
        assert torch.equal(decode_self_attention(q, bufs[0], bufs[1], pos, **scales), want)
    assert all(torch.equal(t[:, s:], tail) for t, tail in zip(big, tails))


@pytest.mark.parametrize("dh", [16, 64])
def test_strided_transpose_quant_kv_and_encoder_inputs(dev, dh):
    """The cross-KV quantizer on the k half of a fused (B, S, 2 H dh) K/V
    projection, and the encoder attention with k at a storage offset:
    equal to what they give on contiguous copies, one launch a call."""
    g = torch.Generator(device=dev).manual_seed(dh)
    b, s, h = 2, 1500, 4
    kv = (torch.randn(b, s, 2 * h * dh, generator=g, device=dev) * 0.4).bfloat16()
    x = kv[..., : h * dh]
    before = transpose_quant_kv.launches
    q8, sc = transpose_quant_kv(x, h)
    assert transpose_quant_kv.launches == before + 1
    q_ref, sc_ref = transpose_quant_kv_ref(x.contiguous(), h)
    assert torch.equal(q8, q_ref) and torch.equal(sc, sc_ref)
    q, k, v = _strided_qkv_of_dim(dev, 1, h, 300, dh, dh)
    flat = torch.empty(k.numel() + 4, dtype=k.dtype, device=dev)
    k_off = flat[4:].view(k.shape).copy_(k)
    before = encoder_attention.launches
    got = encoder_attention(q, k_off, v)
    assert encoder_attention.launches == before + 1
    assert torch.equal(got, encoder_attention(q, k.contiguous(), v))


@pytest.mark.parametrize("tree,kv", [("f32", "fp"), ("f32", "int8"), ("f32", "int4"),
                                     ("bf16", "int8")])
@pytest.mark.parametrize("model", ["test2l", "test2l-ts"])
@pytest.mark.parametrize("batch", [3, 4])
def test_test_models_decode_on_the_card(dev, model, batch, tree, kv):
    """The whole decode of the test models (head dim 16) through
    `make_transcribe_fn` on the card, with the caches of each kind, at batch
    4 (B·H = 16: the grouped cross-attention) and 3 (12 rows: the one-query
    kernel): every decode attention kernel launches at head dim 16, and the
    tokens equal the same tree's on the CPU in f32 or part at a tie proven
    there (`chip_smoke.check_ties`)."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_to

    cs = _chip_smoke()
    arch = ARCHS[model]
    params_cpu = init_params(arch, 0, torch.float32, "cpu")
    params = tree_to(params_cpu, dev, torch.float32 if tree == "f32" else torch.bfloat16)
    switches = {"fp": {}, "int8": {"kv_int8": True, "cross_kv_int8": True},
                "int4": {"kv_int8": True, "cross_kv_int4": True}}[kv]
    cfg = DecodeConfig(max_new_tokens=8, language_token_id=None, task_token_id=None,
                       notimestamps=model == "test2l", **switches)
    wav = torch.from_numpy((np.random.default_rng(batch).standard_normal(
        (batch, samples_for_arch(arch))) * 0.1).astype(np.float32))
    counters = cs.zero_launches()
    got, _ = make_transcribe_fn(arch, cfg, device=dev)(params, wav)
    launched = {k: v for k, v in cs.read_launches(counters).items() if v}
    rows = batch * arch.decoder_heads
    if rows % 16:
        assert any(k.startswith("decode_cross_attention_") or k == "decode_cross_attention"
                   for k in launched), launched
    else:
        assert any(k.startswith("decode_cross_attention_grouped") for k in launched), launched
    assert any(k.startswith("decode_self_attention_update") for k in launched), launched
    want, _ = make_transcribe_fn(arch, cfg, device="cpu")(params_cpu, wav)
    assert got.shape == want.shape
    cs.check_ties(f"{model} {tree} {kv}", params_cpu, arch, cfg, wav, got.cpu(), want,
                  len(forced_prefix(arch, cfg)), fast=False)


# ---------------------------------------------------------------------------
# Ragged head dims: every width from 1 to 256 runs the RAGGED body of its
# capacity (the smallest of 16, 32, 64, 128, 256 that holds it). The tests
# above take them as they take the whole widths.

RAGGED_DIMS = [1, 8, 24, 36, 48, 80, 96, 100, 160, 200, 256]
_KINDS_AT = [(dh, kind) for dh in RAGGED_DIMS for kind in ("fp", "int8", "int4")
             if kind != "int4" or dh % 2 == 0]   # packed int4 holds dh / 2 rows


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh,kind", _KINDS_AT)
def test_ragged_dims_cross_attention_grouped(dev, dh, kind, dtype):
    """The grouped kernel's RAGGED bodies, every storage kind under q in each
    type (the f32 ones the second f32 body), as `test_head_dims_cross_
    attention_grouped` holds the whole widths."""
    test_head_dims_cross_attention_grouped(dev, dh, dtype, kind)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh,kind", _KINDS_AT)
def test_ragged_dims_cross_attention_one_query(dev, dh, kind, dtype):
    """The one-query kernel's RAGGED bodies (past 128 the grouped kernel at
    one slot), as `test_head_dims_cross_attention_one_query` holds the
    whole widths."""
    test_head_dims_cross_attention_one_query(dev, dh, dtype, kind)


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", RAGGED_DIMS)
@pytest.mark.parametrize("b,s,h", [(2, 1500, 0), (1, 129, 3)])
def test_ragged_dims_transpose_quant_kv(dev, b, s, h, dh, dtype):
    """The cross-KV quantizer's RAGGED bodies, bit-equal to the plain
    version (rows of dh elements read by elements where dh * elem % 16 != 0)."""
    test_head_dims_transpose_quant_kv(dev, b, s, h, dh, dtype)


@pytest.mark.parametrize("dh", RAGGED_DIMS)
@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 129), (2, 4, 1500)])
def test_ragged_dims_encoder_attention(dev, b, h, t, dh):
    """The encoder attention's RAGGED bodies on views of one fused projection
    (read in place where their strides are multiples of 8 elements, else
    through one zero-padded copy each, counted), within one bf16 step of the
    plain version; contiguous inputs give the same bits."""
    before = encoder_attention.pad_copies
    test_head_dims_encoder_attention(dev, b, h, t, dh)
    copies = encoder_attention.pad_copies - before
    # the fused views' (H dh, dh, 3 H dh) strides, then the contiguous copies'
    aligned_view = dh % 8 == 0 and (3 * h * dh) % 8 == 0
    assert copies == (0 if aligned_view else 3) + (0 if dh % 8 == 0 else 3)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", RAGGED_DIMS)
def test_ragged_dims_self_attention(dev, dh, dtype, with_start, int8):
    """Both cache updates and the read-only attention at RAGGED widths, on
    caches of dh-element rows updated in place (no copy): caches bit-equal,
    the read-only output bit-equal to the update's."""
    test_head_dims_self_attention(dev, dh, dtype, with_start, int8)


# ---------------------------------------------------------------------------
# Head dims past 256: every attention kernel runs its WIDE body, which takes
# the head dim at run time and walks it in chunks; each launch is counted in
# the wrapper's `launches_wide_dh` besides its kind's counter.

WIDE_DIMS = [257, 320, 384, 512, 1024]
_WIDE_KINDS_AT = [(dh, kind) for dh in WIDE_DIMS for kind in ("fp", "int8", "int4")
                  if kind != "int4" or dh % 2 == 0]


def _wide_launches(fn, call):
    before = fn.launches_wide_dh
    call()
    return fn.launches_wide_dh - before


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh,kind", _WIDE_KINDS_AT)
def test_wide_dims_cross_attention_grouped(dev, dh, kind, dtype):
    """The grouped kernel's WIDE body, every storage kind under q in each
    type, as `test_head_dims_cross_attention_grouped` holds the whole widths
    (1, 5 and 8 slots, 24 and 192 rows, poisoned padding): 8 launches, all
    WIDE."""
    assert _wide_launches(decode_cross_attention_grouped, lambda:
                          test_head_dims_cross_attention_grouped(dev, dh, dtype, kind)) == 8


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh,kind", _WIDE_KINDS_AT)
def test_wide_dims_cross_attention_one_query(dev, dh, kind, dtype):
    """The one-query kernel past 256 (the grouped WIDE body at one slot), as
    `test_head_dims_cross_attention_one_query` holds the whole widths."""
    assert _wide_launches(decode_cross_attention, lambda:
                          test_head_dims_cross_attention_one_query(dev, dh, dtype, kind)) == 2


@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", WIDE_DIMS)
@pytest.mark.parametrize("b,s,h", [(2, 1500, 2), (1, 129, 3)])
def test_wide_dims_transpose_quant_kv(dev, b, s, h, dh, dtype):
    """The cross-KV quantizer's WIDE body: codes and scales bit-equal to the
    plain version (the absmax over the whole dh before any code)."""
    assert _wide_launches(transpose_quant_kv, lambda:
                          test_head_dims_transpose_quant_kv(dev, b, s, h, dh, dtype)) == 1


@pytest.mark.parametrize("dh", WIDE_DIMS)
@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 129), (2, 2, 1500)])
def test_wide_dims_encoder_attention(dev, b, h, t, dh):
    """The encoder attention's WIDE body in bf16 on views of one fused
    projection, read in place where every stride is a multiple of 8
    elements (its tensor maps need 16-byte rows; else through one
    zero-padded copy each of q, k and v, counted), within one bf16 step of
    the plain version; contiguous inputs give the same bits."""
    before = encoder_attention.pad_copies
    assert _wide_launches(encoder_attention, lambda:
                          test_head_dims_encoder_attention(dev, b, h, t, dh)) == 2
    # the fused views, then the contiguous copies: each padded where dh % 8
    assert encoder_attention.pad_copies == before + (6 if dh % 8 else 0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("with_start", [False, True], ids=["nostart", "start"])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
@pytest.mark.parametrize("dh", WIDE_DIMS)
def test_wide_dims_self_attention(dev, dh, dtype, with_start, int8):
    """Both cache updates and the read-only attention at WIDE widths:
    caches and scales bit-equal to the plain version's (the int8 codes from
    the absmax over the whole dh), the read-only output bit-equal to the
    update's."""
    fns = (decode_self_attention_update_int8 if int8 else decode_self_attention_update,
           decode_self_attention)
    before = [f.launches_wide_dh for f in fns]
    test_head_dims_self_attention(dev, dh, dtype, with_start, int8)
    assert [f.launches_wide_dh - b for f, b in zip(fns, before)] == [3, 3]


@pytest.mark.parametrize("dh", [64, 96, 384])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=_IDS.get)
def test_encoder_attention_f16_f32(dev, dtype, dh):
    """The encoder attention in f16 (the tensor-core body with f16 operands;
    at 384 the WIDE one) and f32 (3xTF32 on the tensor cores, at 384 the
    CUDA-core body: f32-accurate products) at (8, 768 / Dh, 1500, Dh) on
    views of (B, T, H Dh)
    projections: within one f16 step (2**-10) or 1e-5 of the plain version's
    largest output, one launch counted in the type's counter; contiguous
    inputs give the same bits."""
    h, t = 768 // dh, 1500
    g = torch.Generator(device=dev).manual_seed(dh)
    q, k, v = (whisper.split_heads(torch.randn(8, t, h * dh, generator=g, device=dev)
                                   .to(dtype), h) for _ in range(3))
    attr = "launches" + _COUNTER[dtype]
    before = getattr(encoder_attention, attr)
    got = encoder_attention(q, k, v)
    assert getattr(encoder_attention, attr) == before + 1
    ref = encoder_attention_ref(q, k, v)
    assert got.shape == (8, h, t, dh) and got.dtype == dtype
    assert got.transpose(1, 2).is_contiguous() and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(dtype, float(ref.float().abs().max())))
    assert torch.equal(encoder_attention(q.contiguous(), k.contiguous(), v.contiguous()),
                       got)


@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
@pytest.mark.parametrize("batch", [3, 4])
def test_small_h8_decode_on_the_card(dev, batch, kv):
    """whisper-small's width cut into 8 heads of 96 (`small-h8`), 2 layers,
    bf16 weights: the decode through `make_transcribe_fn` launches the
    RAGGED bodies of capacity 128 at batch 4 (32 rows: grouped) and 3 (24:
    one-query), and the tokens equal the same tree's on the CPU in f32 or
    part at a tie proven there."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.models.decode import forced_prefix
    from openai_whisper_compression_tpu_torch.models.params import init_params, tree_to

    cs = _chip_smoke()
    arch = ARCHS["small"].replace(name="small-h8", encoder_heads=8, decoder_heads=8,
                                  encoder_layers=2, decoder_layers=2)
    assert arch.head_dim == 96
    params_cpu = init_params(arch, 0, torch.float32, "cpu")
    params = tree_to(params_cpu, dev, torch.bfloat16)
    switches = {"fp": {}, "int8": {"kv_int8": True, "cross_kv_int8": True},
                "int4": {"kv_int8": True, "cross_kv_int4": True}}[kv]
    cfg = DecodeConfig(max_new_tokens=8, suppress_tokens=(arch.eos_token_id,), **switches)
    wav = torch.from_numpy((np.random.default_rng(batch).standard_normal(
        (batch, samples_for_arch(arch))) * 0.1).astype(np.float32))
    counters = cs.zero_launches()
    got, _ = make_transcribe_fn(arch, cfg, device=dev)(params, wav)
    launched = {k: v for k, v in cs.read_launches(counters).items() if v}
    grouped = batch * arch.decoder_heads % 16 == 0
    assert any(k.startswith("decode_cross_attention_grouped" if grouped else
                            "decode_cross_attention_") or (not grouped and
                                                           k == "decode_cross_attention")
               for k in launched), launched
    assert any(k.startswith("decode_self_attention_update") for k in launched), launched
    assert launched.get("encoder_attention", 0) == 2, launched
    want, _ = make_transcribe_fn(arch, cfg, device="cpu")(params_cpu, wav)
    assert got.shape == want.shape
    cs.check_ties(f"small-h8 {kv}", params_cpu, arch, cfg, wav, got.cpu(), want,
                  len(forced_prefix(arch, cfg)), fast=False)


def test_flops_per_second_of_a_model_call_on_the_card(dev):
    """`utils.profiling.flops_per_second` of a decode on the card gives a
    rate: every kernel the call launched adds the cost its JAX Pallas
    counterpart declares, so the count is no longer aten ops' alone."""
    import numpy as np

    from openai_whisper_compression_tpu_torch.config import ARCHS, DecodeConfig
    from openai_whisper_compression_tpu_torch.evaluation.harness import (
        make_transcribe_fn, samples_for_arch)
    from openai_whisper_compression_tpu_torch.models.params import init_params
    from openai_whisper_compression_tpu_torch.utils import profiling

    arch = ARCHS["test2l"]
    params = init_params(arch, 0, torch.bfloat16, dev)
    fn = make_transcribe_fn(arch, DecodeConfig(max_new_tokens=8, kv_int8=True,
                                               cross_kv_int8=True), device=dev)
    wav = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (4, samples_for_arch(arch))) * 0.1).astype(np.float32)).to(dev)
    costs = profiling.cost_analysis(fn, params, wav)
    assert costs["transcendentals"] > 0 and costs["flops"] > 0
    perf = profiling.flops_per_second(fn, params, wav, iters=2)
    assert perf["achieved_tflops"] is not None and perf["achieved_tflops"] > 0


# ---------------------------------------------------------------------------
# The f32 encoder attention on the tensor cores (3xTF32) at every capacity,
# the 16-bit WIDE body, and every wrapper past the grid's 65535 rows (the
# launchers walk them from a persistent grid or launch in slices).

def _qkv(dev, b, h, t, dh, dtype, seed):
    """(B, H, T, dh) views of three (B, T, H dh) projections."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [whisper.split_heads(torch.randn(b, t, h * dh, generator=g, device=dev)
                                .to(dtype), h) for _ in range(3)]


def _held_encoder(q, k, v, attr):
    before = getattr(encoder_attention, attr)
    got = encoder_attention(q, k, v)
    assert getattr(encoder_attention, attr) == before + 1
    ref = encoder_attention_ref(q, k, v)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=_tol(q.dtype, float(ref.float().abs().max())))
    return got


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256, 8, 36, 100, 200, 255])
@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 129), (1, 2, 1500), (3, 2, 257)])
def test_f32_encoder_attention_every_capacity(dev, b, h, t, dh):
    """The 3xTF32 body of each capacity (16-256) at whole and ragged head
    dims, within 1e-5 of the plain version's largest output, on views (16-byte
    copies where dh % 4 == 0, 4-byte ones otherwise); contiguous inputs give
    the same bits."""
    q, k, v = _qkv(dev, b, h, t, dh, torch.float32, b + h + t + dh)
    got = _held_encoder(q, k, v, "launches_f32")
    assert torch.equal(encoder_attention(q.contiguous(), k.contiguous(), v.contiguous()),
                       got)


@pytest.mark.parametrize("dh", [64, 98, 256])
def test_f32_encoder_attention_on_offset_views(dev, dh):
    """Views that start one element in and skip a column (rows 4-byte
    aligned only), and a transposed head layout: read in place."""
    q, k, v = _qkv(dev, 2, 3, 301, dh + 1, torch.float32, dh)
    _held_encoder(*(x[:, :, 1:, 1:] for x in (q, k, v)), "launches_f32")
    _held_encoder(*(x.transpose(0, 1) for x in (q, k, v)), "launches_f32")


def test_f32_encoder_attention_peaked_scores(dev):
    """`test_encoder_attention_peaked_scores` in f32: scores of 30 to 45, the
    running maximum moving while the keys stream by."""
    q, k, v = (x.float() for x in _strided_qkv(dev, 1, 4, 1500, 5, scale=4.0))
    q, k = q.clone(), k.clone()
    q[..., 0], k[..., 0] = 8.0, 30.0
    _held_encoder(q, k, v, "launches_f32")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=_IDS.get)
@pytest.mark.parametrize("dh", [257, 288, 384, 512])
@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 129), (2, 2, 1500), (1, 1, 65)])
def test_wide_encoder_attention_16_bit(dev, b, h, t, dh, dtype):
    """The 16-bit WIDE body (the scores of a tile once, the output dims
    shared over two warpgroups) within one step of its type of the plain
    version, one launch counted in the type's counter and in
    `launches_wide_dh`; contiguous inputs give the same bits."""
    q, k, v = _qkv(dev, b, h, t, dh, dtype, b + h + t + dh)
    before = encoder_attention.launches_wide_dh
    got = _held_encoder(q, k, v, "launches" + _COUNTER[dtype])
    assert encoder_attention.launches_wide_dh == before + 1
    assert torch.equal(encoder_attention(q.contiguous(), k.contiguous(), v.contiguous()),
                       got)


@pytest.mark.parametrize("dh", [64, 288])
@pytest.mark.parametrize("dtype", FLOATS, ids=_IDS.get)
def test_encoder_attention_past_65535_heads(dev, dtype, dh):
    """B*H = 70000 at T = 8, which the grid's y extent once refused."""
    _held_encoder(*_qkv(dev, 35000, 2, 8, dh, dtype, dh), "launches" + _COUNTER[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_log_mel_past_65535_clips(dev, dtype):
    """70000 clips of 800 samples (launched in slices of 65535): no less
    exact than the plain version against float64, as `test_log_mel`."""
    test_log_mel(dev, dtype, 70000, 800, 80, 7)


@pytest.mark.parametrize("b,h", [(70000, 1), (1, 70000)])
def test_transpose_quant_kv_past_65535(dev, b, h):
    """B or H = 70000 (launched in slices of 65535 clips or heads): codes and
    scales bit for bit."""
    test_transpose_quant_kv(dev, torch.bfloat16, b, 8, h)


def test_int8_matmul_past_65535_row_tiles(dev):
    """M = 65535 * 128 + 1 rows at K = 32 (launched in slices of 65535 row
    tiles): within one bf16 step, the last row included."""
    test_int8_matmul(dev, torch.bfloat16, 65535 * 128 + 1, 32, 64)

