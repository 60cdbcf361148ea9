"""The port's `utils/writers.py` (a copy of the JAX package's) against the
JAX package's: every format of every result shape written byte-equal,
`get_writer` naming the same files."""

import pytest

from openai_whisper_compression_tpu.utils import writers as jax_writers
from openai_whisper_compression_tpu_torch.utils import writers

RESULTS = {
    "segments": {"text": "hello world again",
                 "segments": [{"start": 0.0, "end": 1.5, "text": " hello world"},
                              {"start": 1.5, "end": 3.75, "text": " again"}]},
    "words": {"text": "hi there",
              "segments": [{"start": 0.25, "end": 2.0, "text": " hi there"}],
              "words": [{"start": 0.25, "end": 0.9, "word": " hi"},
                        {"start": 1.0, "end": 2.0, "word": " there"}]},
    "segmentless": {"text": "plain decode"},
    "open_ended": {"text": "x", "segments": [{"start": 1.0, "end": None, "text": "x"}]},
    "rollover": {"text": "x", "segments": [{"start": 3661.25, "end": 3662.0,
                                            "text": "x"}]},
    "unicode": {"text": "naïve – ünïcode", "segments": [
        {"start": 0.0, "end": 1.0, "text": " naïve –"},
        {"start": 1.0, "end": 2.004, "text": " ünïcode"}]},
}


def test_formats_match_jax():
    assert list(writers.FORMATS) == list(jax_writers.FORMATS)


@pytest.mark.parametrize("fmt", ["txt", "json", "srt", "vtt", "tsv"])
@pytest.mark.parametrize("case", sorted(RESULTS))
def test_every_format_byte_equal_to_jax(tmp_path, fmt, case):
    res = RESULTS[case]
    got = writers.write_result(res, fmt, str(tmp_path / f"p.{fmt}"), duration=2.5)
    want = jax_writers.write_result(res, fmt, str(tmp_path / f"j.{fmt}"), duration=2.5)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_get_writer_all_matches_jax(tmp_path):
    res = RESULTS["words"]
    got = writers.get_writer("all", str(tmp_path / "p"))(res, "/audio/clip.wav", duration=4.0)
    want = jax_writers.get_writer("all", str(tmp_path / "j"))(res, "/audio/clip.wav",
                                                              duration=4.0)
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises((KeyError, ValueError)):
        writers.get_writer("doc", str(tmp_path))
