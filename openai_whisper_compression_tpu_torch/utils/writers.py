"""Transcription output writers: txt / json / srt / vtt / tsv.

A copy of the JAX package's `utils/writers.py` (framework-free): the
result-serialisation role OpenAI's whisper CLI plays (whisper/utils.py
WriteTXT/WriteVTT/WriteSRT/WriteTSV/WriteJSON; the reference repo consumes
transcripts as raw strings only, its evaluation.py:60-75, so this is a
serving-surface superset). Writers consume the result dict produced by
`evaluation.longform.transcribe_seek` / the top-level `transcribe`:

    {"text": str,
     "segments": [{"start": float, "end": float|None, "text": str}, ...],
     "words":    [{"start": float, "end": float, "word": str}, ...]}  # opt

Only "text" is required; formats that need segments synthesise a single
whole-audio segment when none are present, so every format works on the
plain (no-timestamps) decode path too.
"""
from __future__ import annotations

import json
import os
from typing import Callable, TextIO

__all__ = ["FORMATS", "get_writer", "write_result"]


def _segments(result: dict, duration: float | None) -> list[dict]:
    """Segments list, synthesising one whole-audio segment if absent."""
    segs = result.get("segments")
    if segs:
        return segs
    end = duration if duration is not None else None
    return [{"start": 0.0, "end": end, "text": result.get("text", "")}]


def _fmt_clock(seconds: float, *, decimal: str, hours_sep: str = ":") -> str:
    """`HH:MM:SS<decimal>mmm` (srt uses ',', vtt uses '.')."""
    ms = max(0, round(seconds * 1000.0))
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1_000)
    return f"{h:02d}{hours_sep}{m:02d}{hours_sep}{s:02d}{decimal}{ms:03d}"


def _seg_end(seg: dict, fallback_pad: float = 1.0) -> float:
    """Segment end time; open-ended segments get start + pad."""
    end = seg.get("end")
    if end is None:
        end = float(seg.get("start", 0.0)) + fallback_pad
    return float(end)


def write_txt(result: dict, f: TextIO, **_kw) -> None:
    for seg in _segments(result, None):
        f.write(seg["text"].strip() + "\n")


def write_json(result: dict, f: TextIO, **_kw) -> None:
    json.dump(result, f, ensure_ascii=False, indent=2)
    f.write("\n")


def write_srt(result: dict, f: TextIO, *, duration: float | None = None,
              **_kw) -> None:
    for i, seg in enumerate(_segments(result, duration), start=1):
        start = _fmt_clock(float(seg.get("start", 0.0)), decimal=",")
        end = _fmt_clock(_seg_end(seg), decimal=",")
        f.write(f"{i}\n{start} --> {end}\n{seg['text'].strip()}\n\n")


def write_vtt(result: dict, f: TextIO, *, duration: float | None = None,
              **_kw) -> None:
    f.write("WEBVTT\n\n")
    for seg in _segments(result, duration):
        start = _fmt_clock(float(seg.get("start", 0.0)), decimal=".")
        end = _fmt_clock(_seg_end(seg), decimal=".")
        f.write(f"{start} --> {end}\n{seg['text'].strip()}\n\n")


def write_tsv(result: dict, f: TextIO, *, duration: float | None = None,
              **_kw) -> None:
    """start/end in integer milliseconds (matches whisper's WriteTSV)."""
    f.write("start\tend\ttext\n")
    for seg in _segments(result, duration):
        start = round(float(seg.get("start", 0.0)) * 1000)
        end = round(_seg_end(seg) * 1000)
        text = seg["text"].strip().replace("\t", " ")
        f.write(f"{start}\t{end}\t{text}\n")


FORMATS: dict[str, Callable[..., None]] = {
    "txt": write_txt,
    "json": write_json,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
}


def write_result(result: dict, fmt: str, path: str,
                 duration: float | None = None) -> str:
    """Write `result` in `fmt` to `path`; returns the path written."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown output format {fmt!r}; "
                         f"choose from {sorted(FORMATS)} or 'all'")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        FORMATS[fmt](result, f, duration=duration)
    return path


def get_writer(fmt: str, output_dir: str) -> Callable[[dict, str], list[str]]:
    """Writer closure: (result, audio_path) -> written file paths.

    fmt="all" writes every format, like `whisper --output_format all`.
    """
    fmts = sorted(FORMATS) if fmt == "all" else [fmt]
    for x in fmts:
        if x not in FORMATS:
            raise ValueError(f"unknown output format {x!r}; "
                             f"choose from {sorted(FORMATS)} or 'all'")

    def writer(result: dict, audio_path: str,
               duration: float | None = None) -> list[str]:
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        return [write_result(result, x,
                             os.path.join(output_dir, f"{stem}.{x}"),
                             duration=duration)
                for x in fmts]

    return writer
