"""Per-batch memory and CPU tracking: the JAX package's
`evaluation/memory.py` over torch's allocator. psutil CPU% and RSS, device
memory from `torch.cuda.memory_stats()` (the allocator's current and peak
bytes) and `torch.cuda.mem_get_info()` (the card's total), under the JAX
package's keys (`hbm_in_use_mb`, `hbm_peak_mb`, `hbm_limit_mb`) so that
artifacts compare; a bounded deque of samples, a summary and a JSON dump.
Where the device reports nothing (the CPU), an analytic footprint
(`analytic_hbm_mb`) stands in, flagged `hbm_analytic`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ..models import params as P

logger = logging.getLogger("whisper_eval")


def analytic_hbm_mb(params, arch, batch_size: int, *, beam: int = 1,
                    kv_int8: bool = False, cross_kv_bytes: float = 2.0,
                    cache_len: int = 64, audio_samples: int = 480_000,
                    audio_resident: bool = True,
                    cross_s: int | None = None) -> float:
    """Steady-state device footprint model (MB) of a greedy/beam decode
    batch, term for term the JAX package's: parameters + device-resident
    audio + encoder output + cross-attention K/V + self-attention KV cache.
    cross_s: the attended encoder length after token merging (default the
    full encoder output)."""
    mb = 1.0 / 2 ** 20
    d = arch.d_model
    s = cross_s if cross_s is not None else arch.max_source_positions
    s_pad = -(-s // 128) * 128
    total = P.size_in_mb(params)
    if audio_resident:
        total += batch_size * audio_samples * 4 * mb
    total += batch_size * arch.max_source_positions * d * 2 * mb   # enc out
    total += (2 * arch.decoder_layers * batch_size * d * s_pad
              * cross_kv_bytes * mb)                               # cross-KV
    total += (2 * arch.decoder_layers * batch_size * max(beam, 1)
              * d * cache_len * (1 if kv_int8 else 2) * mb)        # self-KV
    return total


def device_memory_stats(device: str | torch.device) -> dict[str, float]:
    """The allocator's bytes in use and at peak on `device`, and its total
    memory, in MB; {} unless `device` is a card that torch sees."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    scale = 1.0 / (1024 ** 2)
    return {
        "hbm_in_use_mb": stats.get("allocated_bytes.all.current", 0) * scale,
        "hbm_peak_mb": stats.get("allocated_bytes.all.peak", 0) * scale,
        "hbm_limit_mb": torch.cuda.mem_get_info(device)[1] * scale,
    }


class MemoryTracker:
    """Samples CPU%/RSS and the memory of `device` per logged batch:
    `log_memory`, `get_memory_summary`, `save_metrics`, `print_summary`,
    `close`. `evaluate_model` points `device` at the device its params live
    on."""

    def __init__(self, model_name: str, save_path: str | None = None,
                 max_samples: int = 500,
                 device: str | torch.device = P.DEFAULT_DEVICE):
        self.model_name = model_name
        self.device = torch.device(device)
        self.save_path = save_path
        self.samples: deque[dict[str, Any]] = deque(maxlen=max_samples)
        self.start_time = time.time()
        self.analytic_mb: float | None = None
        self._proc = None
        try:
            import psutil

            self._proc = psutil.Process(os.getpid())
            self._proc.cpu_percent(interval=None)  # prime the counter
        except Exception:
            pass
        self.initial = self._snapshot()

    def set_analytic(self, params, arch, batch_size: int, *, beam: int = 1,
                     kv_int8: bool = False, cross_kv_bytes: float = 2.0,
                     cache_len: int = 64,
                     audio_resident: bool = True) -> None:
        """Register the analytic footprint as the fallback where the device
        reports no memory: snapshots then carry it, flagged
        ``"hbm_analytic": true``, instead of zeros."""
        self.analytic_mb = analytic_hbm_mb(
            params, arch, batch_size, beam=beam, kv_int8=kv_int8,
            cross_kv_bytes=cross_kv_bytes, cache_len=cache_len,
            audio_resident=audio_resident)

    def _snapshot(self) -> dict[str, Any]:
        snap: dict[str, Any] = {"ts": time.time() - self.start_time}
        if self._proc is not None:
            snap["cpu_percent"] = self._proc.cpu_percent(interval=None)
            snap["rss_mb"] = self._proc.memory_info().rss / (1024 ** 2)
        stats = device_memory_stats(self.device)
        if not stats.get("hbm_peak_mb") and self.analytic_mb is not None:
            stats = {"hbm_in_use_mb": self.analytic_mb,
                     "hbm_peak_mb": self.analytic_mb, "hbm_analytic": True}
        snap.update(stats)
        return snap

    def log_memory(self, split: str | None = None, batch_idx: int | None = None,
                   batch_size: int | None = None, audio_duration: float | None = None,
                   latency: float | None = None) -> None:
        snap = self._snapshot()
        snap.update({k: v for k, v in dict(
            split=split, batch_idx=batch_idx, batch_size=batch_size,
            audio_duration=audio_duration, latency=latency).items()
            if v is not None})
        self.samples.append(snap)

    def get_memory_summary(self) -> dict[str, Any]:
        if not self.samples:
            return {"model": self.model_name, "num_samples": 0}

        def agg(key):
            vals = [s[key] for s in self.samples if key in s]
            if not vals:
                return None
            return {"mean": float(np.mean(vals)), "max": float(np.max(vals)),
                    "min": float(np.min(vals)), "std": float(np.std(vals))}

        return {
            "model": self.model_name,
            "num_samples": len(self.samples),
            "duration_s": time.time() - self.start_time,
            "cpu_percent": agg("cpu_percent"),
            "rss_mb": agg("rss_mb"),
            "hbm_in_use_mb": agg("hbm_in_use_mb"),
            "hbm_peak_mb": agg("hbm_peak_mb"),
            "hbm_analytic": any(s.get("hbm_analytic") for s in self.samples),
            "initial": self.initial,
        }

    def save_metrics(self, path: str | None = None) -> str | None:
        path = path or self.save_path
        if path is None:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"summary": self.get_memory_summary(),
                       "samples": list(self.samples)}, f, indent=2)
        return path

    def print_summary(self) -> None:
        s = self.get_memory_summary()
        logger.info("memory summary for %s: %s", self.model_name,
                    json.dumps(s, default=str)[:2000])

    def close(self) -> None:
        self.print_summary()
        if self.save_path:
            self.save_metrics()
