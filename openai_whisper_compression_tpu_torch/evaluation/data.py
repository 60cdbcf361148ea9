"""Dataset pipeline: LibriSpeech streaming loader + synthetic fallback.

A framework-free copy of the JAX package's `evaluation/data.py` (numpy
waveforms; `synthetic_dataset` gives the same arrays bit for bit), reading
audio through the port's own `runtime_native`. `load_librispeech(num_samples,
split)`, `prepare_datasets` calibration/test splitting, and, because
accelerator hosts often run with no egress, a deterministic synthetic
dataset with the same record schema ({audio, text, duration}) for tests and
offline runs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..config import SAMPLE_RATE


@dataclass
class Utterance:
    audio: np.ndarray       # float32 waveform @ 16 kHz
    text: str               # reference transcript
    duration: float         # seconds
    uid: str = ""


def _librispeech_attempts(split: str, ds_major: int,
                          supports_trc: bool) -> list[tuple[str, dict]]:
    """Ordered (repo_id, load_dataset kwargs) attempts for one logical split.

    datasets >= 3 removed script-based loading (`trust_remote_code`), so the
    classic `librispeech_asr` loading script can never succeed there; the
    hub's Parquet conversion lives under `openslr/librispeech_asr` and loads
    natively. Older datasets run the script repo exactly as the reference
    does (`data_utils.py:8-41`). Split spellings differ across the two: the
    script exposes "test.clean"/"test.other" on the default config while the
    Parquet repo uses config "clean"/"other" with split "test" — both are
    tried, caller-spelling first.
    """
    script_kw: dict = {"split": split}
    if supports_trc:
        script_kw["trust_remote_code"] = True
    attempts = [("librispeech_asr", script_kw),
                ("openslr/librispeech_asr", {"split": split})]
    if "." in split:  # "test.clean" -> config "clean", split "test"
        s, cfg = split.split(".", 1)
        attempts.append(("openslr/librispeech_asr",
                         {"name": cfg, "split": s}))
    if ds_major >= 3:  # script path is dead there — try Parquet repo first
        attempts = attempts[1:] + attempts[:1]
    return attempts


def load_librispeech(num_samples: int | None = None,
                     split: str = "test.clean") -> list[Utterance]:
    """Streaming LibriSpeech loader (HF datasets), same semantics as reference
    `data_utils.py:8-41`. Raises RuntimeError when the hub is unreachable."""
    import inspect

    try:
        import datasets as _hfds
        from datasets import load_dataset

        try:
            ds_major = int(str(getattr(_hfds, "__version__",
                                       "0")).split(".")[0])
        except ValueError:
            ds_major = 0
        supports_trc = ("trust_remote_code"
                        in inspect.signature(load_dataset).parameters)
        stream, errors = None, []
        for repo, kw in _librispeech_attempts(split, ds_major, supports_trc):
            try:
                stream = load_dataset(repo, streaming=True, **kw)
                break
            except Exception as e:  # noqa: BLE001 — collect, try next form
                errors.append(f"{repo}({kw.get('name', '')}): {e}")
        if stream is None:
            raise ConnectionError("; ".join(errors))
        if num_samples:
            stream = stream.take(num_samples)
        out = []
        for rec in stream:
            wav = np.asarray(rec["audio"]["array"], np.float32)
            out.append(Utterance(
                audio=wav, text=rec["text"],
                duration=len(wav) / rec["audio"]["sampling_rate"],
                uid=str(rec.get("id", len(out)))))
        return out
    except Exception as e:  # no network / no cache
        raise RuntimeError(
            f"LibriSpeech unavailable ({e}); use synthetic_dataset() offline"
        ) from e


def read_audio_file(path: str, sample_rate: int = SAMPLE_RATE,
                    assume_rate: int | None = None) -> np.ndarray:
    """Read a .flac (native decoder — what LibriSpeech actually ships),
    .wav (16-bit PCM, any rate/channels) or .npy (float waveform) into a
    mono float32 array at `sample_rate`. Resampling rides the C++
    BatchLoader (runtime_native) — the same path the serving frontend uses.
    `assume_rate` sets the source rate for .npy files (default: already at
    `sample_rate`)."""
    if path.endswith(".npy"):
        wav = np.load(path).astype(np.float32).reshape(-1)
        sr = assume_rate or sample_rate
    elif path.endswith(".flac"):
        from ..runtime_native import flac_decode

        with open(path, "rb") as f:
            samples, sr, bits = flac_decode(f.read())
        wav = samples.astype(np.float32) / float(1 << (bits - 1))
        if wav.shape[1] > 1:
            wav = wav.mean(axis=1)
        else:
            wav = wav[:, 0]
    else:
        import wave

        with wave.open(path, "rb") as w:
            if w.getsampwidth() != 2:
                raise ValueError(
                    f"{path}: only 16-bit PCM .wav supported "
                    f"(got sample width {w.getsampwidth()} bytes)")
            sr = w.getframerate()
            raw = w.readframes(w.getnframes())
            wav = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            if w.getnchannels() > 1:
                wav = wav.reshape(-1, w.getnchannels()).mean(axis=1)
    if sr != sample_rate:
        if sample_rate == SAMPLE_RATE:
            # native threaded path (hardwired to the model's 16 kHz)
            from ..runtime_native import BatchLoader

            n_out = int(len(wav) * sample_rate / sr)
            loader = BatchLoader(1, n_out)
            loader.submit(0, wav, sample_rate=sr)
            wav = loader.flush()[0]
        else:
            # arbitrary target: linear interpolation (BatchLoader only
            # resamples to 16 kHz — runtime_native.py)
            n_out = int(len(wav) * sample_rate / sr)
            x = np.linspace(0.0, len(wav) - 1.0, max(n_out, 1))
            wav = np.interp(x, np.arange(len(wav)), wav)
    return np.ascontiguousarray(wav, np.float32)


def _dir_transcripts(root) -> dict[str, str]:
    """Collect LibriSpeech-style `*.trans.txt` ("uid text...") and sidecar
    `<stem>.txt` transcripts under `root`, keyed by uid/stem."""
    out: dict[str, str] = {}
    for tf in sorted(root.rglob("*.trans.txt")):
        for line in tf.read_text().splitlines():
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def load_audio_dir(path: str, transcripts: str | None = None,
                   num_samples: int | None = None,
                   sample_rate: int = SAMPLE_RATE) -> list[Utterance]:
    """Local-directory dataset: real-audio WER with zero egress.

    Recursively collects `.flac`/`.wav`/`.npy` under `path` (sorted for
    determinism) — so an unpacked LibriSpeech split (FLAC + `*.trans.txt`)
    works verbatim. Reference text per file, first match wins:
      1. `transcripts` — a TSV/two-column file of "uid<TAB or space>text"
         (uid = file stem);
      2. LibriSpeech layout — any `*.trans.txt` in the tree (so an unpacked
         LibriSpeech split works verbatim, same records the reference's HF
         loader yields — `data_utils.py:8-41`);
      3. a sidecar `<stem>.txt` next to the audio file;
      4. "" (transcribable, WER meaningless — flagged by the caller).
    """
    from pathlib import Path

    root = Path(path)
    if not root.is_dir():
        raise FileNotFoundError(f"audio dir {path!r} does not exist")
    files = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in (".flac", ".wav", ".npy"))
    if num_samples:
        files = files[:num_samples]
    if not files:
        raise RuntimeError(f"no .flac/.wav/.npy files under {path!r}")
    table: dict[str, str] = {}
    if transcripts:
        for line in Path(transcripts).read_text().splitlines():
            parts = (line.strip().split("\t", 1) if "\t" in line
                     else line.strip().split(maxsplit=1))
            if len(parts) == 2:
                table[parts[0]] = parts[1]
    trans = _dir_transcripts(root)
    # parallel decode: the native FLAC decoder + resampler run outside the
    # GIL (ctypes), so threads give real speedup on multi-file corpora
    from concurrent.futures import ThreadPoolExecutor

    from ..runtime_native import available

    available()  # build/load the native lib once, not racing in N threads
    with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
        wavs = list(ex.map(lambda f: read_audio_file(str(f), sample_rate),
                           files))
    out = []
    for f, wav in zip(files, wavs):
        stem = f.stem
        text = table.get(stem) or trans.get(stem) or ""
        if not text:
            side = f.with_suffix(".txt")
            if side.exists():
                text = side.read_text().strip()
        out.append(Utterance(audio=wav, text=text,
                             duration=len(wav) / sample_rate, uid=stem))
    return out


def synthetic_dataset(num_samples: int = 16, seed: int = 0,
                      vocab_size: int = 500, min_words: int = 3,
                      max_words: int = 12,
                      min_dur: float = 2.0, max_dur: float = 10.0) -> list[Utterance]:
    """Deterministic synthetic utterances with the LibriSpeech record schema.

    Audio is a word-keyed tone sequence plus noise; transcripts come from the
    WordTokenizer vocabulary ("w17 w384 ..."), so the full pipeline
    (features → model → decode → WER) runs end-to-end offline.
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_samples):
        n_words = int(rng.integers(min_words, max_words + 1))
        words = rng.integers(0, vocab_size, n_words)
        dur = float(rng.uniform(min_dur, max_dur))
        n = int(dur * SAMPLE_RATE)
        t = np.arange(n) / SAMPLE_RATE
        wav = 0.01 * rng.standard_normal(n).astype(np.float32)
        seg = n // max(n_words, 1)
        for j, w in enumerate(words):
            f = 80.0 + (w % 64) * 50.0  # word-keyed tone
            sl = slice(j * seg, (j + 1) * seg)
            wav[sl] += (0.3 * np.sin(2 * np.pi * f * t[sl])).astype(np.float32)
        uid = hashlib.md5(f"{seed}:{i}".encode()).hexdigest()[:8]
        out.append(Utterance(audio=wav, duration=dur, uid=uid,
                             text=" ".join(f"w{int(w)}" for w in words)))
    return out


def prepare_datasets(num_cal: int = 8, num_test: int = 16, seed: int = 0,
                     use_librispeech: bool = False,
                     audio_dir: str | None = None,
                     transcripts: str | None = None) -> dict[str, list[Utterance]]:
    """Calibration/test splits for clean+other, matching the reference's
    4-way dict (`data_utils.py:64-116`). `audio_dir` substitutes a local
    directory (load_audio_dir) for both the hub and the synthetic set —
    the "other" split is empty in that mode (one local corpus)."""
    if audio_dir:
        clean = load_audio_dir(audio_dir, transcripts, num_cal + num_test)
        if len(clean) <= num_cal:
            raise RuntimeError(
                f"audio dir {audio_dir!r} holds {len(clean)} usable files "
                f"but num_cal={num_cal} — the test split would be empty "
                f"(WER on zero utterances reads 0.0); lower "
                f"--calibration-samples or add files")
        return {"calibration_clean": clean[:num_cal],
                "test_clean": clean[num_cal:],
                "calibration_other": [], "test_other": []}
    if use_librispeech:
        clean = load_librispeech(num_cal + num_test, "test.clean")
        other = load_librispeech(num_cal + num_test, "test.other")
    else:
        clean = synthetic_dataset(num_cal + num_test, seed=seed)
        other = synthetic_dataset(num_cal + num_test, seed=seed + 1)
    return {
        "calibration_clean": clean[:num_cal],
        "test_clean": clean[num_cal:],
        "calibration_other": other[:num_cal],
        "test_other": other[num_cal:],
    }


def batch_iterator(dataset: list[Utterance],
                   batch_size: int) -> Iterator[list[Utterance]]:
    for i in range(0, len(dataset), batch_size):
        yield dataset[i: i + batch_size]
