"""The attention kernels' wrappers on the CPU: what they hand the kernels
at every head dim the kernels are built for (16, 32, 64, 128), on strided
and offset views, and over long caches, checked without a card or nvcc.

Each wrapper's card path (`_launch_*`) runs here on CPU tensors with the
kernel library replaced by a recorder (`FakeLib`): it records every
launcher's arguments, and the cache updates' launchers write a mark into
row `pos` of the caches they are handed, so that a test sees where the
write lands. Holds: the head dim passed to the launcher; every pointer the
kernels read in 16-byte pieces aligned; a view the kernel cannot read in
place replaced by a contiguous copy, and a contiguous aligned tensor (the
Dh = 64 main path) passed as it is, with no copy; row `pos` of a strided or
offset cache written back into the caller's view and nothing else of the
buffer around it touched; caches of 16384 rows taken; head dims past 256
(257, 258) handed to the WIDE bodies (capacity `kernels.WIDE`); head dim 0
and, for packed int4 K/V, an odd one refused with a message that names the
bound. And `utils/compile_cache.py` against the JAX package's semantics."""

import ctypes
import os
from pathlib import Path

import pytest
import torch

from openai_whisper_compression_tpu_torch.ops import attention as att
from openai_whisper_compression_tpu_torch.ops import cross_attention as ca
from openai_whisper_compression_tpu_torch.ops import kernels
from openai_whisper_compression_tpu_torch.ops import self_attention_step as sas

DIMS = [16, 32, 64, 128]
MARK = 7   # the byte the fake cache updates write into row pos


class FakeLib:
    """Stands in for the kernel library: each launcher records its
    arguments and returns 0; the cache updates also set every byte of row
    pos of the caches (and, for int8, of the scales) they are handed to
    MARK."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            if name in ("owc_self_attention_update", "owc_self_attention_update_int8"):
                self._mark(name, args)
            return 0
        return launch

    def _mark(self, name, args):
        int8 = name.endswith("int8")
        bh, s, pos, code, dh, cap = args[-7:-1]
        elem = 1 if int8 else {0: 4, 1: 2, 2: 2}[code]
        for ptr in args[3:5]:   # the K and V caches
            for g in range(bh):
                ctypes.memset(ptr + ((g * s + pos) * dh) * elem, MARK, dh * elem)
        if int8:
            for ptr in args[5:7]:   # the scales
                for g in range(bh):
                    ctypes.memset(ptr + (g * s + pos) * 4, MARK, 4)

    def of(self, name):
        return [a for n, a in self.calls if n == name]


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLib()
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return fake


def _aligned(*ptrs):
    return all(p % 16 == 0 for p in ptrs if p)


def test_require_head_dim_names_the_four():
    """The four whole widths, and every other width up to 256, are taken;
    257 and 1024 too, served by the WIDE bodies; 0 is refused naming the
    bound, an odd width for packed int4."""
    for dh in (*DIMS, 1, 8, 48, 96, 255, 256):
        kernels.require_head_dim("x", dh)
        assert kernels.head_dim_capacity(dh) == next(c for c in (16, 32, 64, 128, 256)
                                                     if c >= dh)
    for dh in (257, 1024):
        kernels.require_head_dim("x", dh)
        assert kernels.head_dim_capacity(dh) == kernels.WIDE
    with pytest.raises(ValueError, match=r"head dim must be at least 1, got 0"):
        kernels.require_head_dim("x", 0)
    for dh in (1, 37, 255):
        kernels.require_head_dim("x", dh)
        with pytest.raises(ValueError, match=rf"even head dim .*got {dh}"):
            kernels.require_head_dim("x", dh, int4=True)


@pytest.mark.parametrize("dh", DIMS)
def test_transpose_quant_kv_head_dims_and_views(lib, dh):
    h = 3
    x = torch.randn(2, 300, h * dh, dtype=torch.bfloat16)
    before = ca.transpose_quant_kv.launches
    q, sc = ca._launch_transpose_quant_kv(x, h)
    (args,) = lib.of("owc_transpose_quant_kv")
    assert args[0] == x.data_ptr() and args[-3:-1] == (dh, dh) and q.shape == (2 * h, dh, 384)
    assert ca.transpose_quant_kv.launches == before + 1
    fused = torch.randn(2, 300, 2 * h * dh, dtype=torch.bfloat16)
    ca._launch_transpose_quant_kv(fused[..., h * dh:], h)   # a strided half
    args = lib.of("owc_transpose_quant_kv")[-1]
    assert args[0] != fused.data_ptr() + h * dh * 2 and _aligned(args[0])
    q, sc = ca._launch_transpose_quant_kv(torch.zeros(1, 10, 2 * 257), 2)   # WIDE
    args = lib.of("owc_transpose_quant_kv")[-1]
    assert args[-3:-1] == (257, kernels.WIDE) and q.shape == (2, 257, 128)


def _kv(kind, bh, dh, s_pad, dtype):
    if kind == "fp":
        return torch.randn(bh, dh, s_pad, dtype=dtype), torch.randn(bh, dh, s_pad,
                                                                     dtype=dtype), None, None
    rows = dh if kind == "int8" else dh // 2
    k, v = (torch.randint(-127, 128, (bh, rows, s_pad), dtype=torch.int8) for _ in range(2))
    return k, v, torch.rand(bh, 1, s_pad), torch.rand(bh, 1, s_pad)


def _offset(t):
    """t's values at a storage offset of one element (no 16-byte rows)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dh", DIMS)
def test_cross_attention_head_dims_and_views(lib, dh, kind):
    bh, s_pad = 24, 1536
    k, v, ks, vs = _kv(kind, bh, dh, s_pad, torch.float32)
    q = torch.randn(bh, 3, dh)
    ca._launch_decode_cross_attention_grouped(q, k, v, ks, vs, 1500)
    args = lib.of("owc_cross_attention_grouped")[-1]
    assert args[-3:-1] == (dh, dh) and args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[-5] == {"fp": 0, "int8": 1, "int4": 2}[kind]
    q1 = torch.randn(bh, dh)
    ca._launch_decode_cross_attention(q1, k, v, ks, vs, 1500)
    args = lib.of("owc_cross_attention")[-1]
    assert args[-3:-1] == (dh, dh) and args[0] == q1.data_ptr() and args[1] == k.data_ptr()
    # q a slice of a fused projection, K/V and scales at an offset: copies
    fused = torch.randn(bh, 3 * dh)
    views = [_offset(t) if t is not None else None for t in (k, v, ks, vs)]
    ca._launch_decode_cross_attention(fused[:, dh: 2 * dh], *views, 1500)
    args = lib.of("owc_cross_attention")[-1]
    assert _aligned(*args[:5]) and args[1] != views[0].data_ptr()
    ca._launch_decode_cross_attention_grouped(fused.view(bh, 3, dh)[:, 1:], *views, 1500)
    args = lib.of("owc_cross_attention_grouped")[-1]
    assert _aligned(*args[:5]) and args[8] == 2 * dh   # row stride of 2 slots
    ca._launch_decode_cross_attention(torch.randn(bh, 258), *_kv(kind, bh, 258, s_pad,
                                                                 torch.float32), 1500)
    assert lib.of("owc_cross_attention")[-1][-3:-1] == (258, kernels.WIDE)   # WIDE


@pytest.mark.parametrize("dh", DIMS)
def test_encoder_attention_head_dims_and_views(lib, dh):
    b, h, t = 2, 3, 300
    fused = torch.randn(b, t, 3 * h * dh).bfloat16()
    q, k, v = (fused[..., i * h * dh: (i + 1) * h * dh].view(b, t, h, dh).transpose(1, 2)
               for i in range(3))
    out = att._launch_encoder_attention(q, k, v)
    args = lib.of("owc_encoder_attention")[-1]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())   # read in place
    assert args[7:9] == (dh, dh) and args[9] == pytest.approx(dh ** -0.5)
    assert out.shape == (b, h, t, dh) and out.transpose(1, 2).is_contiguous()
    k_off = _offset(k.contiguous())
    att._launch_encoder_attention(q, k_off, v)
    args = lib.of("owc_encoder_attention")[-1]
    assert args[1] != k_off.data_ptr() and _aligned(args[1])
    before = att.encoder_attention.pad_copies
    att._launch_encoder_attention(*(torch.zeros(1, 2, 256, 257).bfloat16(),) * 3)   # WIDE
    args = lib.of("owc_encoder_attention")[-1]
    # the WIDE body's tensor maps need 16-byte rows: 257 columns pad to 264
    assert args[7:9] == (257, kernels.WIDE) and att.encoder_attention.pad_copies == before + 3
    assert list(args[10][3:6]) == [2 * 256 * 264, 256 * 264, 264]


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dh", DIMS)
def test_self_attention_head_dims_views_and_long_caches(lib, dh, int8):
    bh, s, pos, extra = 6, 16384, 16383, 8
    fused = torch.randn(bh, 3 * dh)
    q, kn, vn = (fused[:, i * dh: (i + 1) * dh] for i in range(3))
    if int8:
        big = [torch.zeros(bh, s + extra, dh, dtype=torch.int8) for _ in range(2)]
        big += [torch.zeros(bh, s + extra) for _ in range(2)]
        fn, name = sas._launch_decode_self_attention_update_int8, "owc_self_attention_update_int8"
    else:
        big = [torch.zeros(bh, s + extra, dh) for _ in range(2)]
        fn, name = sas._launch_decode_self_attention_update, "owc_self_attention_update"
    # contiguous caches: passed as they are (no copy), the mark in row pos
    caches = [t[:, :s].contiguous() for t in big]
    fn(q.contiguous(), kn.contiguous(), vn.contiguous(), *caches, pos)
    args = lib.of(name)[-1]
    assert [args[3], args[4]] == [caches[0].data_ptr(), caches[1].data_ptr()]
    assert args[-3:-1] == (dh, dh) and args[-6] == s
    assert all(bool((c[:, pos] != 0).all()) and not bool(c[:, :pos].any()) for c in caches)
    # prefix views of longer buffers: written through copies, row pos only
    views = [t[:, :s] for t in big]
    fn(q, kn, vn, *views, pos)
    args = lib.of(name)[-1]
    assert args[3] != views[0].data_ptr() and _aligned(*args[:5])
    for t in big:
        assert bool((t[:, pos] != 0).all())
        assert not bool(t[:, :pos].any()) and not bool(t[:, s:].any())
    # a cache past the kernels' position arithmetic (a view of no memory)
    with pytest.raises(ValueError, match="at most"):
        huge = [torch.zeros(1, 1, 1, dtype=c.dtype).expand(bh, sas.MAX_CACHE_ROWS + 1, dh)
                if c.dim() == 3 else torch.zeros(1, 1).expand(bh, sas.MAX_CACHE_ROWS + 1)
                for c in caches]
        fn(q, kn, vn, *huge, 0)
    z = torch.ones(bh, 257)   # WIDE: the mark lands in row 1 of rows 257 long
    wide = [torch.zeros(bh, 8, 257, dtype=c.dtype) if c.dim() == 3 else torch.zeros(bh, 8)
            for c in caches]
    fn(z, z, z, *wide, 1)
    assert lib.of(name)[-1][-3:-1] == (257, kernels.WIDE)
    assert all(bool((c[:, 1] != 0).all()) and not bool(c[:, 2:].any()) for c in wide)


@pytest.mark.parametrize("dh", DIMS)
def test_read_only_self_attention_head_dims_and_views(lib, dh):
    bh, s = 6, 16384
    kc, vc = (torch.randn(bh, s + 4, dh)[:, :s] for _ in range(2))
    q = torch.randn(bh, 2 * dh)[:, dh:]
    sas._launch_decode_self_attention(q, kc, vc, s - 1)
    args = lib.of("owc_self_attention")[-1]
    assert args[-3:-1] == (dh, dh) and args[-5] == s - 1 and _aligned(*args[:3])
    kq, vq = (torch.zeros(bh, s, dh, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.ones(bh, s + 1)[:, 1:] for _ in range(2))
    sas._launch_decode_self_attention(q, kq, vq, 9000, k_scale=ks, v_scale=vs)
    args = lib.of("owc_self_attention_int8")[-1]
    assert args[1:3] == (kq.data_ptr(), vq.data_ptr()) and args[3] != ks.data_ptr()
    assert args[-3:-1] == (dh, dh)


# ----------------------------------------------------------- compile cache

@pytest.fixture
def cache(monkeypatch):
    from openai_whisper_compression_tpu_torch.utils import compile_cache

    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_configured", None)
    monkeypatch.delenv("OWC_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    return compile_cache


def test_compile_cache_moves_the_library(cache, tmp_path):
    default = kernels.library_path()
    assert cache.enable_persistent_compilation_cache(str(tmp_path)) == str(tmp_path)
    assert kernels.library_path() == tmp_path / default.name
    assert kernels.BUILD_DIR == tmp_path


def test_compile_cache_first_configurer_wins_explicit_overrides(cache, tmp_path, monkeypatch):
    first, second = tmp_path / "a", tmp_path / "b"
    monkeypatch.setenv(cache.ENV_DIR, str(first))
    assert cache.enable_persistent_compilation_cache() == str(first)   # the env var
    assert cache.enable_persistent_compilation_cache() == str(first)   # a bare call keeps it
    monkeypatch.setenv(cache.ENV_DIR, str(second))
    assert cache.enable_persistent_compilation_cache() == str(first)
    assert cache.enable_persistent_compilation_cache(str(second)) == str(second)
    assert kernels.BUILD_DIR == second and second.is_dir()


def test_compile_cache_opt_out(cache, monkeypatch):
    monkeypatch.setenv("OWC_NO_COMPILE_CACHE", "1")
    assert cache.enable_persistent_compilation_cache() is None
    tmp = Path(kernels.BUILD_DIR)
    assert tmp.is_dir() and tmp != cache.DEFAULT_DIR and os.access(tmp, os.W_OK)
    assert cache.enable_persistent_compilation_cache(min_secs=0.0) is None


def test_cli_configures_the_cache_at_import(tmp_path):
    """Importing the port's CLI points the library at the cache, as
    importing JAX's CLI enables XLA's (here relocated by the env var)."""
    import subprocess
    import sys

    code = ("import openai_whisper_compression_tpu_torch.cli\n"
            "from openai_whisper_compression_tpu_torch.ops import kernels\n"
            "print(kernels.library_path().parent)")
    env = {k: v for k, v in os.environ.items() if k != "OWC_NO_COMPILE_CACHE"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**env, "OWC_KERNEL_CACHE_DIR": str(tmp_path / "c")},
                         cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(tmp_path / "c")
