"""The WIDE cross-attention body's launches and the f32 WIDE encoder body's
counter, on the CPU: what the card paths (`_launch_*`) of both
cross-attention wrappers hand the WIDE body (head dims past 256) at the row
counts, s_valid values and slot counts its design splits on, with the
kernel library replaced by `test_torch_head_dims.FakeLib`, which records
every launcher's arguments.

Holds: each WIDE launch (`cap` = `kernels.WIDE`) receives the split count
of `wide_splits` (at most 8 blocks, each given at least one 64-position
chunk; one block an SM of the H100's 132 while B·H rows fit, about two
past that), from the one-query wrapper too, whose narrower widths keep
`one_query_splits`; a window of slots is one launch for every 8 of them,
each with its own slots of q and out at the row stride of the whole window
(the body picks its slot template, 1, 4 or 8, from that count: a one-slot
launch does one slot's work); the f32 encoder attention past 256 counts
its launch in `launches_f32_wide_dh` beside `launches_f32` and
`launches_wide_dh`, and no other type or width does."""

import pytest
import torch

from openai_whisper_compression_tpu_torch.models.whisper import split_heads
from openai_whisper_compression_tpu_torch.ops import attention as att
from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
from openai_whisper_compression_tpu_torch.ops import kernels
from test_torch_head_dims import FakeLib

ROWS = [1, 6, 17, 64, 66, 192, 1024]
S_VALID = [1, 127, 129, 1500]
# the argument positions of the two launchers (ops/kernels.py _SIGNATURES)
G_BH, G_KQ, G_STRIDE, G_SPAD, G_SVALID, G_SPLITS, G_DH, G_CAP = 6, 7, 8, 9, 10, 11, 14, 15
O_BH, O_SPLITS, O_SVALID, O_DH, O_CAP = 6, 7, 9, 12, 13


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLib()
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return fake


def _kv(kind: str, bh: int, dh: int, s_valid: int, dtype=torch.bfloat16):
    """Uninitialised K/V of the kind (the recording library reads nothing)."""
    s_pad = -(-s_valid // 128) * 128
    if kind == "fp":
        return (*torch.empty(2, bh, dh, s_pad, dtype=dtype), None, None)
    rows = dh // 2 if kind == "int4" else dh
    return (*torch.empty(2, bh, rows, s_pad, dtype=torch.int8),
            *torch.ones(2, bh, 1, s_pad))


@pytest.mark.parametrize("s_valid", S_VALID)
@pytest.mark.parametrize("bh", ROWS + [132, 133, 264, 2 ** 31 - 1])
def test_wide_splits_gives_every_block_a_chunk(bh, s_valid):
    """The WIDE rule: 132 // B·H blocks a row while B·H <= 132 (one wave of
    at most one block an SM), ceil(264 / B·H) past that, at most 8, no more
    than the row's 64-position chunks (the f32 body's 32-position chunks
    are more)."""
    splits = ca.wide_splits(bh, s_valid)
    chunks = -(-s_valid // 64)
    per_row = 132 // bh if bh <= 132 else -(-264 // bh)
    assert splits == max(1, min(8, chunks, per_row))
    assert 1 <= splits <= min(8, chunks) and splits <= -(-s_valid // 32)
    assert bh * splits <= 132 or splits == 1 or bh * splits < 264 + bh


@pytest.mark.parametrize("kq", [1, 3, 5, 8, 12])
@pytest.mark.parametrize("s_valid", S_VALID)
@pytest.mark.parametrize("bh", [1, 6, 17, 64])
@pytest.mark.parametrize("kind,dtype", [("fp", torch.bfloat16), ("fp", torch.float32),
                                        ("fp", torch.float16), ("int8", torch.bfloat16),
                                        ("int4", torch.float32)],
                         ids=["bf16", "f32", "f16", "int8", "int4"])
def test_wide_grouped_launches_hand_splits_and_slots(lib, kind, dtype, bh, s_valid, kq):
    """A grouped call at Dh 384: one WIDE launch for every 8 slots, each of
    at most 8 slots at its offset of q and out, the window's row stride, the
    `wide_splits` count; counted in `launches_wide_dh` once a launch."""
    dh = 384
    k, v, ks, vs = _kv(kind, bh, dh, s_valid, dtype)
    q = torch.randn(bh, kq, dh).to(dtype)
    before = ca.decode_cross_attention_grouped.launches_wide_dh
    out = ca._launch_decode_cross_attention_grouped(q, k, v, ks, vs, s_valid)
    launches = lib.of("owc_cross_attention_grouped")
    starts = list(range(0, kq, 8))
    assert len(launches) == len(starts)
    assert ca.decode_cross_attention_grouped.launches_wide_dh == before + len(starts)
    for args, j0 in zip(launches, starts):
        slots = min(8, kq - j0)
        offset = j0 * dh * q.element_size()
        assert args[0] == q.data_ptr() + offset and args[5] == out.data_ptr() + offset
        assert (args[G_BH], args[G_KQ], args[G_STRIDE], args[G_SVALID]) == (
            bh, slots, kq * dh, s_valid)
        assert args[G_SPLITS] == ca.wide_splits(bh, s_valid)
        assert (args[G_DH], args[G_CAP]) == (dh, kernels.WIDE)
        assert args[G_SPAD] == k.shape[2]


@pytest.mark.parametrize("s_valid", S_VALID)
@pytest.mark.parametrize("bh", ROWS)
@pytest.mark.parametrize("dh", [64, 288, 384])
def test_wide_one_query_launch_takes_the_wide_split_rule(lib, dh, bh, s_valid):
    """A one-query call past 256 runs the grouped WIDE body at one slot over
    `wide_splits` blocks; at a whole width the one-query kernel keeps
    `one_query_splits`."""
    k, v, ks, vs = _kv("int8", bh, dh, s_valid)
    q = torch.randn(bh, dh).bfloat16()
    before = ca.decode_cross_attention.launches_wide_dh
    ca._launch_decode_cross_attention(q, k, v, ks, vs, s_valid)
    (args,) = lib.of("owc_cross_attention")
    wide = dh > 256
    rule = ca.wide_splits if wide else ca.one_query_splits
    assert args[O_SPLITS] == rule(bh, s_valid)
    assert (args[O_BH], args[O_SVALID], args[O_DH]) == (bh, s_valid, dh)
    assert args[O_CAP] == (kernels.WIDE if wide else 64)
    assert ca.decode_cross_attention.launches_wide_dh == before + wide


@pytest.mark.parametrize("dh", [64, 256, 257, 288, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_f32_wide_encoder_launch_is_counted(lib, dtype, dh):
    """The encoder attention on views of a (B, T, 3 H Dh) projection: an f32
    call past 256 reaches the launcher (dtype code 0, capacity WIDE) and
    counts one launch in `launches_f32`, `launches_wide_dh` and
    `launches_f32_wide_dh`; the other types and widths leave the last
    alone."""
    b, h, t = 2, 2, 260
    fused = torch.randn(b, t, 3 * h * dh).to(dtype)
    q, k, v = (split_heads(fused[..., i * h * dh: (i + 1) * h * dh], h) for i in range(3))
    names = ("launches_f32_wide_dh", "launches_wide_dh", "launches_f32")
    before = [getattr(att.encoder_attention, n) for n in names]
    att._launch_encoder_attention(q, k, v)
    (args,) = lib.of("owc_encoder_attention")
    assert args[7:9] == (dh, kernels.head_dim_capacity(dh))
    assert args[11] == kernels.DTYPE_CODES[dtype]
    f32, wide = dtype == torch.float32, dh > 256
    assert [getattr(att.encoder_attention, n) - b0 for n, b0 in zip(names, before)] == [
        int(f32 and wide), int(wide), int(f32)]
    if f32:   # read in place: the f32 bodies take any view whose head dim is contiguous
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
