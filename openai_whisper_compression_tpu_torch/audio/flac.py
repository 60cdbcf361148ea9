"""Pure-Python FLAC decoder (container + all subframe types).

A framework-free copy of the JAX package's `audio/flac.py`: the fallback of
`runtime_native.flac_decode` where the native runtime is not built.

Why this exists: real LibriSpeech trees ship `.flac`, and no FLAC library
(soundfile, torchaudio, librosa, ffmpeg) is a dependency of the package.
Without a decoder, the zero-egress ingestion path
(`evaluation/data.py::load_audio_dir`) could read only `.wav`/`.npy`, i.e.
NOT an unpacked LibriSpeech split. This module is the dependency-free
reference decoder; the native C++ runtime
(`runtime/src/owc_flac.cpp`, via `runtime_native.flac_decode`) implements
the identical algorithm at file-IO speed and is preferred when built.

Scope: the full FLAC subset used by libFLAC encodings of speech corpora —
fixed & variable blocksize, constant / verbatim / fixed(0-4) / LPC(1-32)
subframes, Rice and Rice2 partitioned residuals incl. escape partitions,
wasted bits, and all stereo decorrelation modes (left/side, right/side,
mid/side). Frame CRCs are parsed but not verified (integrity belongs to the
storage layer; see `storage/formats.py::verify_roundtrip` for the pattern).

Layout follows RFC 9639 (the FLAC format). No code is derived from libFLAC.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["FlacInfo", "decode_flac", "parse_stream_info"]


@dataclass
class FlacInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int  # per channel; 0 = unknown in STREAMINFO


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    __slots__ = ("buf", "pos", "bit")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos          # byte position
        self.bit = 0            # bits consumed within buf[pos] (0..7)

    def read(self, n: int) -> int:
        """Read n bits (0 <= n <= 57ish) as an unsigned int."""
        out = 0
        while n > 0:
            if self.pos >= len(self.buf):
                raise EOFError("flac: truncated stream")
            avail = 8 - self.bit
            take = min(n, avail)
            byte = self.buf[self.pos]
            out = (out << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            n -= take
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0 bits up to the terminating 1 bit (RFC 9639 unary)."""
        q = 0
        while True:
            if self.pos >= len(self.buf):
                raise EOFError("flac: truncated unary")
            byte = self.buf[self.pos]
            rem = 8 - self.bit
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                q += rem
                self.bit = 0
                self.pos += 1
                continue
            lead = rem - chunk.bit_length()  # zeros before the first 1
            q += lead
            self.bit += lead + 1             # consume the 1 too
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
            return q

    def align(self):
        if self.bit:
            self.bit = 0
            self.pos += 1

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


def _read_utf8_number(br: _BitReader) -> int:
    """Frame/sample number: UTF-8-style coding extended to 36 bits."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_follow = 0
    mask = 0x40
    while b0 & mask:
        n_follow += 1
        mask >>= 1
    if n_follow < 1 or n_follow > 6:
        raise ValueError("flac: invalid UTF-8 coded number")
    v = b0 & (mask - 1)
    for _ in range(n_follow):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("flac: invalid UTF-8 continuation")
        v = (v << 6) | (b & 0x3F)
    return v


_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
               6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
               11: 96000}

# fixed-predictor coefficients by order (RFC 9639 §9.2.2)
_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"flac: reserved residual method {method}")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = br.read(4)
    n_part = 1 << porder
    if blocksize % n_part or (blocksize >> porder) <= order:
        raise ValueError("flac: invalid partition order")
    out = np.empty(blocksize - order, np.int64)
    w = 0
    for p in range(n_part):
        count = (blocksize >> porder) - (order if p == 0 else 0)
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            if raw == 0:
                out[w:w + count] = 0
            else:
                for i in range(count):
                    out[w + i] = br.read_signed(raw)
        else:
            for i in range(count):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                out[w + i] = (v >> 1) ^ -(v & 1)  # zigzag
        w += count
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: subframe padding bit set")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    if ftype == 0:                      # constant
        s = np.full(blocksize, br.read_signed(ebps), np.int64)
    elif ftype == 1:                    # verbatim
        s = np.empty(blocksize, np.int64)
        for i in range(blocksize):
            s[i] = br.read_signed(ebps)
    elif 8 <= ftype <= 12:              # fixed, order 0-4
        order = ftype - 8
        s = np.empty(blocksize, np.int64)
        for i in range(order):
            s[i] = br.read_signed(ebps)
        res = _decode_residual(br, blocksize, order)
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * s[i - 1 - j]
            s[i] = res[i - order] + pred
    elif ftype >= 32:                   # LPC, order 1-32
        order = (ftype & 31) + 1
        s = np.empty(blocksize, np.int64)
        for i in range(order):
            s[i] = br.read_signed(ebps)
        precision = br.read(4) + 1
        if precision == 16:  # 0b1111 + 1
            raise ValueError("flac: invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        for i in range(order, blocksize):
            pred = 0
            for j in range(order):
                pred += coefs[j] * s[i - 1 - j]
            s[i] = res[i - order] + (pred >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {ftype}")
    if wasted:
        s <<= wasted
    return s


def parse_stream_info(data: bytes) -> tuple[FlacInfo, int]:
    """Parse the fLaC marker + metadata blocks only (no audio decode) →
    (FlacInfo, byte offset of the first frame). Cheap duration/rate probe —
    e.g. `serving.submit_flac` uses it to route short windows to the
    threaded native decoder without touching the audio data host-side."""
    if data[:4] != b"fLaC":
        raise ValueError("flac: missing fLaC marker")
    pos = 4
    info: FlacInfo | None = None
    while True:  # metadata blocks
        if pos + 4 > len(data):
            raise EOFError("flac: truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16); br.read(16)        # min/max blocksize
            br.read(24); br.read(24)        # min/max framesize
            sr = br.read(20)
            ch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            info = FlacInfo(sr, ch, bps, total)
        pos += 4 + length
        if last:
            break
    if info is None:
        raise ValueError("flac: no STREAMINFO block")
    return info, pos


def decode_flac(data: bytes) -> tuple[np.ndarray, FlacInfo]:
    """Decode a FLAC stream → (int32 samples shaped (n, channels), FlacInfo).

    Lossless: output equals the encoder's input PCM exactly.
    """
    info, pos = parse_stream_info(data)

    chunks: list[np.ndarray] = []
    br = _BitReader(data, pos)
    while not br.at_end():
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"flac: bad frame sync {sync:#x}")
        br.read(1)                          # reserved
        br.read(1)                          # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)                          # reserved
        _read_utf8_number(br)               # frame/sample number
        if bs_code == 0:
            raise ValueError("flac: reserved blocksize code")
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise ValueError("flac: invalid sample rate code")
        bps = {0: info.bits_per_sample, 1: 8, 2: 12, 4: 16,
               5: 20, 6: 24, 7: 32}.get(ss_code)
        if bps is None:
            raise ValueError(f"flac: reserved sample size code {ss_code}")
        br.read(8)                          # header CRC-8 (not verified)

        if chan_code < 8:
            n_ch = chan_code + 1
            subs = [_decode_subframe(br, blocksize, bps)
                    for _ in range(n_ch)]
        elif chan_code in (8, 9, 10):
            n_ch = 2
            # side channel carries +1 bit
            if chan_code == 8:              # left/side
                left = _decode_subframe(br, blocksize, bps)
                side = _decode_subframe(br, blocksize, bps + 1)
                subs = [left, left - side]
            elif chan_code == 9:            # right/side
                side = _decode_subframe(br, blocksize, bps + 1)
                right = _decode_subframe(br, blocksize, bps)
                subs = [side + right, right]
            else:                           # mid/side
                mid = _decode_subframe(br, blocksize, bps)
                side = _decode_subframe(br, blocksize, bps + 1)
                mid = (mid << 1) | (side & 1)
                subs = [(mid + side) >> 1, (mid - side) >> 1]
        else:
            raise ValueError(f"flac: reserved channel assignment {chan_code}")
        if n_ch != info.channels:
            raise ValueError("flac: frame channel count != STREAMINFO")
        br.align()
        br.read(16)                         # frame CRC-16 (not verified)
        chunks.append(np.stack(subs, axis=1))

    samples = (np.concatenate(chunks, axis=0) if chunks
               else np.empty((0, info.channels), np.int64))
    if info.total_samples:
        samples = samples[:info.total_samples]
    return samples.astype(np.int32), info
