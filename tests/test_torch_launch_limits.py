"""Inputs past the CUDA grid's 65535 limit, and the f32 encoder attention's
3xTF32 arithmetic, on the CPU.

The card paths (`_launch_*`, or a wrapper handed tensors that report
themselves on the card) run on CPU tensors with the kernel library replaced
by `test_torch_head_dims.FakeLib`, which records every launcher's
arguments. Holds: the encoder attention takes B*H = 70000 in every type
and at every body (a whole, a RAGGED and a WIDE head dim), the log-mel
B = 70000 clips, the cross-KV quantizer B = 70000 or H = 70000, and the four
weight-only matmuls M = 8,388,481 rows (65535 row tiles of 128, and one
more row): each wrapper hands its launcher the whole call, which the
launchers cut into launches of at most 65535 grid rows (or walk from a
persistent grid). Tensors the stand-in never reads are `torch.empty`.

The f32 encoder attention runs on the tensor cores by 3xTF32: each operand
x split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), each product as
a_lo b_hi + a_hi b_lo + a_hi b_hi. A model of that arithmetic here (TF32
rounding emulated on the mantissa's low 13 bits, round to nearest with ties
away as `cvt.rna` rounds; products of two TF32 values are exact in f32) is
held within the kernel's bound, 1e-5 of the plain version's largest output,
on random inputs and on peaked scores, while one TF32 product a pair is
not."""

import numpy as np
import pytest
import torch

from openai_whisper_compression_tpu_torch.audio import mel_kernel
from openai_whisper_compression_tpu_torch.ops import attention as att
from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
from openai_whisper_compression_tpu_torch.ops import kernels
from openai_whisper_compression_tpu_torch.ops import quant_matmul as qm
from test_torch_head_dims import FakeLib

torch.set_num_threads(2)

PAST = 70000                  # grid rows past 65535
M_PAST = 65535 * 128 + 1      # the matmuls' row tiles past 65535


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLib()
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return fake


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper takes
    its card path (whose launch goes to the recording library)."""

    @property
    def is_cuda(self):
        return True


# ------------------------------------------------------------ past 65535

@pytest.mark.parametrize("dh", [16, 36, 288])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("b,h", [(PAST, 1), (PAST // 2, 2)])
def test_encoder_attention_past_65535_heads(lib, b, h, dtype, dh):
    q, k, v = (torch.zeros(b, h, 2, dh, dtype=dtype) for _ in range(3))
    attr = "launches" + att._COUNTER[dtype]
    before = getattr(att.encoder_attention, attr)
    out = att._launch_encoder_attention(q, k, v)
    (args,) = lib.of("owc_encoder_attention")
    assert args[4:9] == (b, h, 2, dh, kernels.head_dim_capacity(dh))
    assert out.shape == (b, h, 2, dh)
    assert getattr(att.encoder_attention, attr) == before + 1


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_log_mel_past_65535_clips(lib, dft_dtype):
    wav = torch.zeros(PAST, 201)   # the shortest clip the reflect pad takes
    before = mel_kernel.log_mel_cuda.launches
    out = mel_kernel._launch_log_mel(wav, 80, dft_dtype)
    (args,) = lib.of("owc_mel_log10")
    assert args[5:9] == (PAST, 604, 2, 80)   # B, row stride, frames, mels
    assert args[10] == kernels.DTYPE_CODES[dft_dtype]
    assert out.shape == (PAST, 80, 1) and mel_kernel.log_mel_cuda.launches == before + 1


@pytest.mark.parametrize("b,h", [(PAST, 1), (1, PAST), (2, 40000)])
def test_transpose_quant_kv_past_65535(lib, b, h):
    x = torch.zeros(b, 3, h * 2, dtype=torch.bfloat16)
    before = ca.transpose_quant_kv.launches
    q, sc = ca._launch_transpose_quant_kv(x, h)
    (args,) = lib.of("owc_transpose_quant_kv")
    assert args[3:7] == (b, 3, h, 128) and args[-3:-1] == (2, 16)
    assert q.shape == (b * h, 2, 128) and sc.shape == (b * h, 1, 128)
    assert ca.transpose_quant_kv.launches == before + 1


def _matmul_case(kind):
    """(wrapper, launcher, x, weight arguments) for an x of M_PAST rows."""
    x = torch.empty(M_PAST, 64, dtype=torch.bfloat16).as_subclass(_OnCard)
    card = lambda t: t.as_subclass(_OnCard)   # noqa: E731
    if kind == "int8":
        return qm.int8_matmul, "owc_int8_matmul", x, (
            card(torch.zeros(64, 128, dtype=torch.int8)), card(torch.ones(128)))
    if kind == "int4":
        return qm.int4_matmul, "owc_int4_matmul", x, (
            card(torch.zeros(32, 128, dtype=torch.int8)), card(torch.ones(128)))
    if kind == "nf4":
        return qm.nf4_matmul, "owc_nf4_matmul", x, (
            card(torch.zeros(32, 128, dtype=torch.int8)), card(torch.ones(1, 128)), "nf4", 64)
    return qm.group_asym_matmul, "owc_group_asym_matmul", x, (
        card(torch.zeros(64, 128, dtype=torch.uint8)), card(torch.ones(1, 128)),
        card(torch.zeros(1, 128)), 64)


@pytest.mark.parametrize("kind", ["int8", "int4", "nf4", "hqq_u8"])
def test_quant_matmul_past_65535_row_tiles(lib, kind):
    fn, launcher, x, weights = _matmul_case(kind)
    out = fn(x, *weights)
    (args,) = lib.of(launcher)
    m_at = 4 if kind in ("int8", "int4") else 5   # a code table or zeros before out
    assert args[m_at] == M_PAST and out.shape == (M_PAST, 128)


# ------------------------------------------------------------ 3xTF32

def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
    half of the dropped 13 bits' weight added to the magnitude, then the 13
    bits cleared (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, three: bool = True) -> torch.Tensor:
    """a @ b in 3xTF32 (the small products first), or as one TF32 product."""
    (ah, al), (bh, bl) = split(a), split(b)
    if not three:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def attention_tf32(q, k, v, three: bool = True) -> torch.Tensor:
    """The f32 encoder attention with both products in (3x)TF32: q scaled in
    f32, scores and softmax in f32, the unnormalised probabilities into the
    value product, divided by their f32 sum."""
    s = product(q * (q.shape[-1] ** -0.5), k.transpose(-1, -2), three)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return product(p, v, three) / p.sum(dim=-1, keepdim=True)


def _random_qkv(seed, shape=(1, 2, 1500, 64)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in range(3)]


def _peaked_qkv():
    """`test_encoder_attention_peaked_scores`'s inputs in f32: q scaled by 4,
    q[..., 0] = 8 and k[..., 0] = 30, so scores run from 30 to 45 with a few
    dominant keys a row."""
    q, k, v = _random_qkv(5, (1, 4, 1500, 64))
    q = q * 4.0
    q[..., 0], k[..., 0] = 8.0, 30.0
    return q, k, v


@pytest.mark.parametrize("case", ["random", "peaked"])
def test_3xtf32_holds_the_f32_bound(case):
    q, k, v = _random_qkv(21) if case == "random" else _peaked_qkv()
    ref = att.encoder_attention_ref(q, k, v)
    got = attention_tf32(q, k, v)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("case", ["random", "peaked"])
def test_one_tf32_product_breaks_the_f32_bound(case):
    q, k, v = _random_qkv(21) if case == "random" else _peaked_qkv()
    ref = att.encoder_attention_ref(q, k, v)
    got = attention_tf32(q, k, v, three=False)
    assert float((got - ref).abs().max()) > 1e-5 * float(ref.abs().max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10   # the TF32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one, 3.0]
    hi, lo = split(torch.tensor([1.0 + 2.0 ** -20]))
    assert (hi.item(), lo.item()) == (1.0, 2.0 ** -20)
