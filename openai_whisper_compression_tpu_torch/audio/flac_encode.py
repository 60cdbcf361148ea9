"""Minimal spec-correct FLAC encoder (pure Python).

A framework-free copy of the JAX package's `audio/flac_encode.py`, the
client-side counterpart of the decoders (`runtime/src/owc_flac.cpp`,
`audio/flac.py`): serving clients FLAC-encode utterances for the wire
(`serving.TranscriptionService.submit_flac`), cutting upload bandwidth ~2x
against int16 PCM losslessly. The encoder is spec-derived (RFC 9639):
fixed/LPC/constant/verbatim subframes, 4-bit Rice residuals (+ escape
partitions), stereo decorrelation, wasted bits, the table
blocksize/sample-rate frame codes. Whole blocks only (pad the tail).
"""

from __future__ import annotations

import numpy as np


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int):
        assert 0 <= v < (1 << n) or n == 0
        self.acc = (self.acc << n) | v
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, v: int, n: int):
        self.write(v & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.out)


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
    return c


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for count, bits in ((1, 11), (2, 16), (3, 21), (4, 26), (5, 31), (6, 36)):
        if n < (1 << bits):
            lead = ((0xFF00 >> (count + 1)) & 0xFF) | (n >> (6 * count))
            tail = [0x80 | ((n >> (6 * k)) & 0x3F)
                    for k in range(count - 1, -1, -1)]
            return bytes([lead] + tail)
    raise ValueError(n)


def _zigzag(v: int) -> int:
    return (v << 1) if v >= 0 else (-(v << 1) - 1)


def _write_residual(bw: _BitWriter, res: list[int], blocksize: int,
                    order: int, porder: int, escape: bool):
    bw.write(0, 2)                       # method 0: 4-bit Rice
    bw.write(porder, 4)
    n_part = 1 << porder
    w = 0
    for p in range(n_part):
        count = (blocksize >> porder) - (order if p == 0 else 0)
        part = res[w:w + count]
        w += count
        if escape:
            bw.write(15, 4)              # escape code
            bw.write(20, 5)              # 20 raw bits/sample
            for r in part:
                bw.write_signed(r, 20)
        else:
            zmax = max((_zigzag(r) for r in part), default=0)
            param = min(14, max(0, zmax.bit_length() - 3))
            bw.write(param, 4)
            for r in part:
                z = _zigzag(r)
                bw.write_unary(z >> param)
                bw.write(z & ((1 << param) - 1), param)


def _write_subframe(bw: _BitWriter, s: np.ndarray, bps: int, kind: str,
                    porder: int = 0, escape: bool = False, wasted: int = 0):
    s = [int(v) for v in s]
    bw.write(0, 1)                       # padding
    blocksize = len(s)
    if wasted:
        assert all(v % (1 << wasted) == 0 for v in s)
    ebps = bps - wasted
    sw = [v >> wasted for v in s]

    def _wasted_bits():
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    if kind == "constant":
        assert len(set(sw)) == 1
        bw.write(0, 6)
        _wasted_bits()
        bw.write_signed(sw[0], ebps)
    elif kind == "verbatim":
        bw.write(1, 6)
        _wasted_bits()
        for v in sw:
            bw.write_signed(v, ebps)
    elif kind.startswith("fixed"):
        order = int(kind[5:])
        coefs = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1],
                 4: [4, -6, 4, -1]}[order]
        bw.write(8 + order, 6)
        _wasted_bits()
        for v in sw[:order]:
            bw.write_signed(v, ebps)
        res = [sw[i] - sum(c * sw[i - 1 - j] for j, c in enumerate(coefs))
               for i in range(order, blocksize)]
        _write_residual(bw, res, blocksize, order, porder, escape)
    elif kind == "lpc2":
        order, precision, shift, coefs = 2, 4, 1, [3, -1]
        bw.write(32 | (order - 1), 6)
        _wasted_bits()
        for v in sw[:order]:
            bw.write_signed(v, ebps)
        bw.write(precision - 1, 4)
        bw.write_signed(shift, 5)
        for c in coefs:
            bw.write_signed(c, precision)
        res = [sw[i] - ((sum(coefs[j] * sw[i - 1 - j]
                             for j in range(order))) >> shift)
               for i in range(order, blocksize)]
        _write_residual(bw, res, blocksize, order, porder, escape)
    else:
        raise ValueError(kind)


_BS_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
             1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}
_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
             24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}


def encode_flac(samples: np.ndarray, sample_rate: int = 16000, bps: int = 16,
                blocksize: int = 1024, kind: str = "fixed2",
                stereo: str | None = None, porder: int = 0,
                escape: bool = False, wasted: int = 0,
                ss_from_streaminfo: bool = False,
                table_codes: bool = False) -> bytes:
    """samples: (n,) mono or (n, 2) stereo integers. Returns a FLAC stream."""
    if samples.ndim == 1:
        samples = samples[:, None]
    n, ch = samples.shape
    assert n % blocksize == 0, "test encoder: whole blocks only"

    si = _BitWriter()
    si.write(blocksize, 16); si.write(blocksize, 16)
    si.write(0, 24); si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    for _ in range(16):
        si.write(0, 8)                   # MD5 (decoder does not verify)
    body = si.bytes()
    stream = bytearray(b"fLaC")
    stream.append(0x80)                  # last-block | STREAMINFO
    stream += len(body).to_bytes(3, "big")
    stream += body

    ss_code = 0 if ss_from_streaminfo else {8: 1, 12: 2, 16: 4,
                                            20: 5, 24: 6}[bps]
    for f in range(n // blocksize):
        blk = samples[f * blocksize:(f + 1) * blocksize]
        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1); hdr.write(0, 1)  # reserved, fixed blocksize
        if table_codes:
            # the codes real libFLAC files carry for common sizes/rates
            bs_code = _BS_CODES[blocksize]
            sr_code = _SR_CODES[sample_rate]
        else:
            bs_code = 7                   # blocksize-1 as 16 bits at end
            sr_code = 0                   # sample rate from STREAMINFO
        hdr.write(bs_code, 4)
        hdr.write(sr_code, 4)
        chan_code = {None: ch - 1, "left_side": 8, "right_side": 9,
                     "mid_side": 10}[stereo]
        hdr.write(chan_code, 4)
        hdr.write(ss_code, 3)
        hdr.write(0, 1)
        for b in _utf8_number(f):
            hdr.write(b, 8)
        if bs_code == 7:
            hdr.write(blocksize - 1, 16)
        hbytes = hdr.bytes()
        fw = _BitWriter()
        for b in hbytes:
            fw.write(b, 8)
        fw.write(_crc8(hbytes), 8)

        if stereo is None:
            for c in range(ch):
                _write_subframe(fw, blk[:, c], bps, kind, porder, escape,
                                wasted)
        else:
            L = blk[:, 0].astype(np.int64)
            R = blk[:, 1].astype(np.int64)
            side = L - R
            if stereo == "left_side":
                _write_subframe(fw, L, bps, kind, porder, escape)
                _write_subframe(fw, side, bps + 1, kind, porder, escape)
            elif stereo == "right_side":
                _write_subframe(fw, side, bps + 1, kind, porder, escape)
                _write_subframe(fw, R, bps, kind, porder, escape)
            else:                        # mid/side
                mid = (L + R) >> 1
                _write_subframe(fw, mid, bps, kind, porder, escape)
                _write_subframe(fw, side, bps + 1, kind, porder, escape)
        fw.align()
        frame = fw.bytes()
        stream += frame
        stream += _crc16(frame).to_bytes(2, "big")
    return bytes(stream)


def encode_waveform(wav: np.ndarray, sample_rate: int = 16000,
                    blocksize: int = 1024) -> bytes:
    """float32/-1..1 (or int16) mono waveform -> FLAC bytes (16-bit).
    Pads the tail to a whole block (decoders see trailing silence)."""
    wav = np.asarray(wav)
    if wav.dtype.kind == "f":
        pcm = np.clip(np.round(wav * 32767.0), -32768, 32767).astype(np.int64)
    else:
        pcm = wav.astype(np.int64)
    pad = (-len(pcm)) % blocksize
    if pad:
        pcm = np.concatenate([pcm, np.zeros(pad, np.int64)])
    return encode_flac(pcm, sample_rate=sample_rate, blocksize=blocksize)
