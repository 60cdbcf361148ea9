"""Per-sample evaluation stack (notebook-layer parity).

The port's counterpart of the JAX package's `evaluation/profiler.py`, a
re-design of the reference package layer's eval stack
(`openai_whisper_compression/utils.py`): `ModelProfiler` (:16-178),
`WhisperEvaluator` (:163-268), `VisualizationUtils` (:271-317),
`TranscriptionMetrics` (:320-397), `setup_device` (:400-412) and
`format_time` (:415-423). The torch module walk becomes a tree walk
(QTensor-aware physical sizes, `models.params.size_in_bytes`),
`model.generate` becomes `make_transcribe_fn` at batch 1, and the device is
the card unless the caller asks for the CPU.

Unlike the canonical harness (`harness.py`, batched corpus-level loop),
this stack evaluates ONE utterance at a time and keeps per-sample records
(WER/CER/latency/RSS-delta) — the granularity the reference's EDA notebook
reports (avg/median WER, avg inference time per sample, memory delta per
sample; BASELINE.md cell-15 numbers).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Sequence

import numpy as np

from ..config import DecodeConfig, WhisperArch
from ..models import params as P
from ..ops.qtensor import QTensor
from . import metrics
from .data import Utterance

Record = dict[str, Any]


def setup_device(device: str = "cuda"):
    """The reference's cuda|mps|cpu switch
    (`openai_whisper_compression/utils.py:400-412`): `torch.device("cuda")`,
    or the CPU only when asked (`device="cpu"`); raises where the card is
    asked for and torch sees none. Reports the device it returns."""
    import torch

    dev = P.resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")
    print(f"Using {dev.type.upper()} backend ({kind})")
    return dev


def format_time(seconds: float) -> str:
    """Human-readable duration (`utils.py:415-423`)."""
    if seconds < 60:
        return f"{seconds:.2f}s"
    if seconds < 3600:
        return f"{seconds / 60:.2f}m"
    return f"{seconds / 3600:.2f}h"


class ModelProfiler:
    """Model size profiling + metric logging (`utils.py:16-178`).

    Operates on a params tree instead of an nn.Module: parameter leaves
    are walked via `named_leaves`, and quantized leaves report their packed
    physical bytes (the reference's `element_size()` equivalent)."""

    def __init__(self, model_name: str, results_dir: str = "results"):
        self.model_name = model_name
        self.results_dir = results_dir
        self.metrics_history: list[Record] = []
        self.size_details: Record = {}

    @staticmethod
    def measure_model_size(params: Any) -> float:
        """Physical in-memory size in MB (`utils.py:25-34`)."""
        return P.size_in_mb(params)

    def get_detailed_model_size(self, params: Any) -> Record:
        """Per-leaf size breakdown (`utils.py:36-74`)."""
        layer_info: Record = {}
        total_params = 0
        total_bytes = 0
        for name, leaf in P.named_leaves(params):
            if leaf is None:
                continue
            if isinstance(leaf, QTensor):
                n = int(np.prod(leaf.shape))
                nbytes = leaf.nbytes()
                kind = f"quantized:{leaf.kind}"
            else:
                n = leaf.numel()
                nbytes = n * leaf.element_size()
                kind = str(leaf.dtype).removeprefix("torch.")
            total_params += n
            total_bytes += nbytes
            layer_info[name] = {"size_mb": nbytes / 1024**2,
                                "num_params": n, "type": kind}
        self.size_details = {
            "total_size_mb": total_bytes / 1024**2,
            "param_size_mb": total_bytes / 1024**2,
            "buffer_size_mb": 0.0,  # trees have no module buffers
            "total_params": total_params,
            "layer_info": layer_info,
        }
        return self.size_details

    def log_metrics(self, m: Record) -> None:
        self.metrics_history.append(m)

    def save_metrics(self, filename: str) -> str | None:
        """CSV dump of logged per-sample metrics (`utils.py:105-118`)."""
        if not self.metrics_history:
            print("No metrics to save")
            return None
        os.makedirs(self.results_dir, exist_ok=True)
        path = os.path.join(self.results_dir, filename)
        keys = sorted({k for m in self.metrics_history for k in m})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.metrics_history)
        print(f"Metrics saved to {path}")
        return path

    @staticmethod
    def get_memory_usage() -> float:
        """Current process RSS in MB (`utils.py:120-124`): psutil where it
        is installed, else this process's `/proc/self/statm`."""
        try:
            import psutil
        except ImportError:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 1024**2
        return psutil.Process().memory_info().rss / 1024**2

    def print_size_analysis(self, top_k: int | None = None) -> None:
        """Sorted per-leaf size report (`utils.py:126-143`)."""
        if not self.size_details:
            print("No size analysis available. Run get_detailed_model_size first.")
            return
        d = self.size_details
        print(f"Model Size Analysis for {self.model_name}")
        print("-" * 50)
        print(f"Total Model Size: {d['total_size_mb']:.2f} MB")
        print(f"Total Parameters: {d['total_params']:,}")
        ranked = sorted(d["layer_info"].items(),
                        key=lambda kv: kv[1]["size_mb"], reverse=True)
        for name, info in ranked[:top_k]:
            print(f"{name}: {info['size_mb']:.2f} MB, "
                  f"{info['num_params']:,} params ({info['type']})")

    @staticmethod
    def calculate_error_metrics(reference: str,
                                hypothesis: str) -> tuple[float, float]:
        """(WER, CER) with the basic lowercase/strip-punct normalizer
        (`utils.py:135-158`)."""
        return (metrics.wer([reference], [hypothesis]),
                metrics.cer([reference], [hypothesis]))


class WhisperEvaluator:
    """Per-sample dataset evaluation (`utils.py:163-268`).

    Wraps a params tree + a batch-1 `make_transcribe_fn` on `device` (the
    card unless the caller passes "cpu"; the tree must live there); each
    sample is timed up to its tokens' read-back to the host, which waits
    for the card as the reference's `.generate()` does."""

    def __init__(self, params: Any, arch: WhisperArch, tokenizer,
                 profiler: ModelProfiler | None = None,
                 decode_cfg: DecodeConfig | None = None,
                 device: Any = P.DEFAULT_DEVICE):
        from .harness import make_transcribe_fn, samples_for_arch

        self.params = params
        self.arch = arch
        self.tokenizer = tokenizer
        self.profiler = profiler or ModelProfiler("model")
        self._n_samples = samples_for_arch(arch)
        self._fn = make_transcribe_fn(arch, decode_cfg or DecodeConfig(),
                                      device=device)

    def evaluate_sample(self, audio: np.ndarray, reference: str) -> Record:
        """Transcribe one utterance; WER/CER/latency/RSS-delta record
        (`utils.py:198-228`)."""
        wav = np.zeros((1, self._n_samples), np.float32)
        wav[0, : min(len(audio), self._n_samples)] = \
            np.asarray(audio, np.float32)[: self._n_samples]
        mem_before = self.profiler.get_memory_usage()
        t0 = time.perf_counter()
        tokens, lengths = self._fn(self.params, wav)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        dt = time.perf_counter() - t0
        hyp = self.tokenizer.decode(tokens[0, : lengths[0]])
        w, c = self.profiler.calculate_error_metrics(reference, hyp)
        return {"reference": reference, "hypothesis": hyp, "wer": w, "cer": c,
                "inference_time": dt,
                "memory_used": self.profiler.get_memory_usage() - mem_before}

    def evaluate_dataset(self, dataset: Sequence[Utterance],
                         warmup: bool = True) -> list[Record]:
        """Per-sample records over the dataset (`utils.py:230-256`).
        One warmup sample absorbs first-call costs (the kernels' build and
        load, allocator growth) so latencies are honest."""
        if warmup and len(dataset):
            self.evaluate_sample(dataset[0].audio, dataset[0].text)
        records = []
        for idx, utt in enumerate(dataset):
            r = self.evaluate_sample(utt.audio, utt.text)
            r["sample_id"] = idx
            records.append(r)
            self.profiler.log_metrics(
                {k: r[k] for k in
                 ("wer", "cer", "inference_time", "memory_used")})
        return records

    def save_model(self, model_dir: str) -> str:
        """Checkpoint params (`utils.py:258-268` `save_pretrained`)."""
        from ..storage import checkpoint

        os.makedirs(model_dir, exist_ok=True)
        return checkpoint.save(self.params, os.path.join(model_dir, "params"))


class VisualizationUtils:
    """Per-sample distribution plots (`utils.py:271-317`), headless PNG."""

    @staticmethod
    def _hist_pair(records: list[Record], keys: tuple[str, str],
                   titles: tuple[str, str], xlabels: tuple[str, str],
                   path: str) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, key, title, xl in zip(axes, keys, titles, xlabels):
            ax.hist([r[key] for r in records], bins=20)
            ax.set_title(title)
            ax.set_xlabel(xl)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        print(f"Plot saved to {path}")
        return path

    @classmethod
    def plot_error_distributions(cls, records: list[Record],
                                 path: str) -> str:
        return cls._hist_pair(
            records, ("wer", "cer"),
            ("Distribution of Word Error Rate",
             "Distribution of Character Error Rate"), ("WER", "CER"), path)

    @classmethod
    def plot_performance_metrics(cls, records: list[Record],
                                 path: str) -> str:
        return cls._hist_pair(
            records, ("inference_time", "memory_used"),
            ("Distribution of Inference Time",
             "Distribution of Memory Usage"),
            ("Time (seconds)", "Memory (MB)"), path)


class TranscriptionMetrics:
    """Summary-metric roll-up over per-sample records (`utils.py:320-397`)."""

    @staticmethod
    def calculate_summary_metrics(records: list[Record],
                                  model_size: float | None = None) -> Record:
        def col(k):
            return np.asarray([r[k] for r in records], np.float64)

        wer, cer = col("wer"), col("cer")
        out = {"avg_wer": float(wer.mean()), "median_wer": float(np.median(wer)),
               "std_wer": float(wer.std()),
               "avg_cer": float(cer.mean()), "median_cer": float(np.median(cer)),
               "std_cer": float(cer.std()),
               "avg_inference_time": float(col("inference_time").mean()),
               "avg_memory_used": float(col("memory_used").mean())}
        if model_size is not None:
            out["model_size_mb"] = model_size
        return out

    @staticmethod
    def save_summary(summary: Record, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(summary))
            w.writeheader()
            w.writerow(summary)
        print(f"Summary metrics saved to {path}")
        return path

    @staticmethod
    def print_summary(summary: Record) -> None:
        print("\nSummary Metrics:")
        print("-" * 50)
        groups = {"Error Rates": ["avg_wer", "median_wer", "std_wer",
                                  "avg_cer", "median_cer", "std_cer"],
                  "Performance": ["avg_inference_time", "avg_memory_used",
                                  "model_size_mb"]}
        for group, names in groups.items():
            print(f"\n{group}:")
            for n in names:
                if n in summary:
                    print(f"  {n:.<30} {summary[n]:.4f}")

    @staticmethod
    def print_sample_comparisons(records: list[Record],
                                 n_samples: int = 3) -> None:
        print("\nSample Transcriptions:")
        for r in records[:n_samples]:
            print(f"\nReference:\n{r['reference']}")
            print(f"\nHypothesis:\n{r['hypothesis']}")
            print(f"WER: {r['wer']:.4f}, CER: {r['cer']:.4f}")
            print("-" * 80)
