"""Sweep driver: a config matrix x evaluation, with per-config fault
isolation.

The port of the JAX package's `sweep/driver.py`: per config, apply the
compression → (a calibration pass where the config needs one) → evaluate
each split → record the metrics, sparsity, GFLOPs and size → JSON
artifacts; a config that raises is recorded with its error and the sweep
goes on (reference behaviour, `quantization.py:117-212`). Results are
flushed to `all_results.json` after every config and a rerun resumes under
the same eval / decode fingerprint. Everything runs on `device`, where the
tree must live.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Any

import numpy as np
import torch

from ..config import DecodeConfig, EvalConfig, WhisperArch
from ..evaluation import harness, metrics
from ..evaluation.memory import MemoryTracker
from ..models.params import DEFAULT_DEVICE, size_in_mb
from ..prune.flops import model_gflops
from ..prune.magnitude import sparsity_report
from ..quant import api as quant_api

logger = logging.getLogger("whisper_eval")


def run_sweep(params: Any, arch: WhisperArch, configs: list[dict],
              datasets: dict[str, list], tokenizer,
              eval_cfg: EvalConfig | None = None,
              decode_cfg: DecodeConfig | None = None,
              save_path: str | None = None,
              calibration_split: str = "calibration_clean",
              resume: bool = True,
              device: str | torch.device = DEFAULT_DEVICE) -> dict[str, Any]:
    """Run every config over every test split. Returns {config: results}.

    Results are flushed to `all_results.json` after every config; with
    `resume=True`, configs already complete (present without an "error"
    key) are skipped on a rerun, when the saved fingerprint of the
    eval / decode configuration and the splits equals this run's (else
    every config reruns)."""
    eval_cfg = eval_cfg or EvalConfig()
    decode_cfg = decode_cfg or DecodeConfig()
    all_results: dict[str, Any] = {}
    results_file = os.path.join(save_path, "all_results.json") if save_path else None
    fingerprint = {"eval": dataclasses.asdict(eval_cfg),
                   "decode": dataclasses.asdict(decode_cfg),
                   "splits": sorted(k for k, v in datasets.items() if v)}
    fingerprint = json.loads(json.dumps(fingerprint, default=str))
    if resume and results_file and os.path.exists(results_file):
        with open(results_file) as f:
            saved = json.load(f)
        if saved.pop("_meta", {}).get("fingerprint") == fingerprint:
            all_results = saved
        else:
            logger.warning("all_results.json was produced under a different "
                           "eval/decode configuration: ignoring it and "
                           "rerunning every config")
    # one transcribe function shared by every config
    shared_fn = harness.make_transcribe_fn(arch, decode_cfg, device=device)

    # The offline accuracy axis: with no labelled data, each config also
    # reports WER against the baseline config's transcripts
    # (wer_vs_baseline; 0.0 = the compression left every transcript as it was).
    baseline_name = _baseline_name(configs)
    baseline_hyps: dict[str, dict[str, str]] = {}
    base_norm = metrics.resolve_normalizer(getattr(eval_cfg, "normalizer", "basic"))

    def _load_baseline_hyps(split: str) -> dict[str, str] | None:
        if split in baseline_hyps:
            return baseline_hyps[split]
        if not save_path:
            return None
        tr = os.path.join(save_path, f"{baseline_name}_{split}_transcriptions.json")
        if os.path.exists(tr):
            with open(tr) as f:
                recs = json.load(f)
            baseline_hyps[split] = {r["id"]: r["hypothesis"] for r in recs}
            return baseline_hyps[split]
        return None

    def flush():
        if results_file:
            os.makedirs(save_path, exist_ok=True)
            tmp = results_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump({**all_results, "_meta": {"fingerprint": fingerprint}},
                          f, indent=2, default=str)
            os.replace(tmp, results_file)

    for cfg in configs:
        name = cfg["name"]
        if resume and name in all_results and "error" not in all_results[name]:
            logger.info("config %s already complete: skipping (resume)", name)
            continue
        t0 = time.time()
        try:
            if cfg.get("needs_data"):
                # data-aware quantizers take a calibration callable over the
                # calibration split
                cal = datasets.get(calibration_split) or []
                run_cal = harness.make_calibration_fn(
                    arch, cal, tokenizer, batch_size=min(eval_cfg.batch_size, 4),
                    device=device)
                compressed = cfg["apply"](params, arch, run_cal)
            else:
                compressed = cfg["apply"](params, arch)
            if cfg.get("needs_calibration"):
                cal = datasets.get(calibration_split) or []
                if cal:
                    def run_cal(p):
                        harness.transcribe_batch(
                            shared_fn, p, cal[: eval_cfg.batch_size], tokenizer,
                            eval_cfg.batch_size, harness.samples_for_arch(arch))

                    compressed = quant_api.calibrate_static(compressed, run_cal)

            entry: dict[str, Any] = {
                "model_size_mb": size_in_mb(compressed),
                "sparsity": sparsity_report(compressed)["overall_sparsity"],
                "gflops": model_gflops(compressed, arch)["total_gflops"],
                "splits": {},
            }
            for split, data in datasets.items():
                if split.startswith("calibration") or not data:
                    continue
                tracker = MemoryTracker(f"{name}_{split}")
                scores, records = harness.evaluate_model(
                    compressed, arch, data, tokenizer, eval_cfg=eval_cfg,
                    decode_cfg=decode_cfg, memory_tracker=tracker,
                    transcribe_fn=shared_fn, device=device)
                if name == baseline_name:
                    baseline_hyps[split] = {r["id"]: r["hypothesis"] for r in records}
                else:
                    base = _load_baseline_hyps(split)
                    if base:
                        pairs = [(base[r["id"]], r["hypothesis"])
                                 for r in records if r["id"] in base]
                        if pairs:
                            # the split's own normalizer, so that the two
                            # columns compare
                            b, h = zip(*pairs)
                            scores["wer_vs_baseline"] = metrics.wer(
                                list(b), list(h), normalize=base_norm is not None,
                                normalizer=base_norm)
                            scores["exact_match_vs_baseline"] = float(
                                np.mean([x == y for x, y in pairs]))
                entry["splits"][split] = scores
                if save_path:
                    harness.save_evaluation_results(scores, records, f"{name}_{split}",
                                                    save_path)
                tracker.close()
            entry["elapsed_s"] = time.time() - t0
            all_results[name] = entry
            logger.info("config %s done in %.1fs", name, entry["elapsed_s"])
            del compressed   # the config's device buffers go before the next
            flush()
        except Exception as e:  # fault isolation per config
            logger.error("config %s failed: %s", name, e)
            all_results[name] = {"error": str(e), "traceback": traceback.format_exc()}
            flush()
            continue

    flush()
    return all_results


def _baseline_name(configs: list[dict]) -> str | None:
    """The config run_sweep anchors wer_vs_baseline to: the first baseline*
    or *_0pct entry, else the first config."""
    return next((c["name"] for c in configs
                 if c["name"].startswith("baseline") or c["name"].endswith("_0pct")),
                configs[0]["name"] if configs else None)


def shard_configs(configs: list[dict], process_id: int | None = None,
                  num_processes: int | None = None,
                  keep_baseline: bool = True) -> list[dict]:
    """Round-robin config assignment for a sweep fanned out over processes:
    process i runs configs[i::n]; a baseline config (baseline* or *_0pct)
    is kept on every process, so that each one's wer_vs_baseline resolves
    from its own artifacts. The defaults read `torch.distributed`'s rank and
    world size where it is initialised, else process 0 of 1."""
    if process_id is None or num_processes is None:
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        if process_id is None:
            process_id = dist.get_rank() if live else 0
        if num_processes is None:
            num_processes = dist.get_world_size() if live else 1
    if num_processes <= 1:
        return list(configs)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    bname = _baseline_name(configs)
    baseline = next((c for c in configs if c["name"] == bname), None)
    # replicate a real anchor only; the configs[0] fallback is positional
    if baseline is not None and not (bname.startswith("baseline")
                                     or bname.endswith("_0pct")):
        baseline = None
    rest = [c for c in configs if c is not baseline]
    mine = rest[process_id::num_processes]
    if keep_baseline and baseline is not None:
        mine = [baseline] + mine
    return mine


def merge_host_results(save_path: str, out_file: str = "all_results.json") -> dict[str, Any]:
    """Merge per-process sweep artifacts (`<save_path>/host*/all_results.json`)
    into one result dict and file. A config name on several hosts (the
    shared baseline) takes the first host's entry; the `_meta` fingerprints
    must agree or the merge refuses."""
    import glob

    merged: dict[str, Any] = {}
    meta = None
    files = sorted(glob.glob(os.path.join(save_path, "host*", "all_results.json")))
    if not files:
        raise FileNotFoundError(f"no host*/all_results.json under {save_path!r}")
    for path in files:
        with open(path) as f:
            res = json.load(f)
        m = res.pop("_meta", None)
        if meta is None:
            meta = m
        elif m != meta:
            raise ValueError(f"{path} was produced under a different "
                             "eval/decode fingerprint: refusing to merge")
        for name, entry in res.items():
            merged.setdefault(name, entry)
    out = os.path.join(save_path, out_file)
    with open(out, "w") as f:
        json.dump({**merged, "_meta": meta or {}}, f, indent=2, default=str)
    logger.info("merged %d hosts -> %s (%d configs)", len(files), out, len(merged))
    return merged


def summarize(all_results: dict[str, Any]) -> str:
    """Console table of a sweep's results (≈ the reference's sweep
    summaries, `unstructured_L1_baseline.py:1330-1417`)."""
    lines = [f"{'config':<34} {'size MB':>9} {'sparsity':>9} {'GFLOPs':>8} "
             f"{'WER':>7} {'vsBase':>7} {'RTFx':>8}"]
    for name, r in all_results.items():
        if "error" in r:
            lines.append(f"{name:<34} ERROR: {r['error'][:60]}")
            continue
        split = next(iter(r["splits"].values()), {})
        wer = f"{split['wer']:.3f}" if split.get("wer") is not None else "-"
        vsb = (f"{split['wer_vs_baseline']:.3f}"
               if split.get("wer_vs_baseline") is not None else "-")
        rtfx = f"{split['rtfx']:.1f}" if split.get("rtfx") else "-"
        lines.append(f"{name:<34} {r['model_size_mb']:>9.1f} "
                     f"{r['sparsity']:>9.3f} {r['gflops']:>8.2f} "
                     f"{wer:>7} {vsb:>7} {rtfx:>8}")
    out = "\n".join(lines)
    print(out)
    return out
