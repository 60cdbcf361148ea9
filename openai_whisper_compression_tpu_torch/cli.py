"""Unified CLI of the port: the JAX package's `cli.py` with the same 12
sub-commands and flags, over the port's functions, on the card unless
`--device cpu` says otherwise.

    python -m openai_whisper_compression_tpu_torch.cli evaluate --model tiny --quant quanto_int8
    python -m openai_whisper_compression_tpu_torch.cli sweep --sweep quant --samples 16
    python -m openai_whisper_compression_tpu_torch.cli sensitivity --method gradient
    python -m openai_whisper_compression_tpu_torch.cli analyze --model small
    python -m openai_whisper_compression_tpu_torch.cli compress --save out.zip --verify

Offline: seeded weights (`models.params.init_params`' generator) and the
synthetic dataset by default. `--weights` / `--hf` read real weights from a
local path or a local cache (`models.convert`; nothing is downloaded), and
`--librispeech` fails where the hub is out of reach. A real tokenizer is
looked for (`evaluation.tokenizer.load_tokenizer`) only with real weights
or real data; seeded weights decode with the word tokenizer.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

# The kernel library's on-disk cache (utils/compile_cache.py; opt out with
# OWC_NO_COMPILE_CACHE=1), as the JAX CLI enables XLA's at import.
from .utils.compile_cache import enable_persistent_compilation_cache  # noqa: E402

enable_persistent_compilation_cache()


def _device(args):
    return getattr(args, "device", "cuda")


def _dtype(args) -> torch.dtype:
    return getattr(torch, args.dtype)


def _tokenizer(args, arch):
    """The word tokenizer for seeded weights and synthetic data; a real
    Whisper tokenizer, where one is cached, for real weights or data."""
    from .evaluation.tokenizer import default_tokenizer, load_tokenizer

    real = (getattr(args, "hf", None) or getattr(args, "weights", None)
            or getattr(args, "librispeech", False)
            or getattr(args, "audio_dir", None))
    tok = load_tokenizer(f"openai/whisper-{arch.name}") if real else None
    return tok or default_tokenizer(arch)


def _load_model(args):
    from . import load_model
    from .config import ARCHS
    from .models import params as P

    if getattr(args, "weights", None):
        from .models.convert import load_checkpoint

        return load_checkpoint(args.weights, dtype=_dtype(args),
                               device=_device(args))
    if getattr(args, "hf", None):
        return load_model(hf=args.hf, dtype=_dtype(args), device=_device(args))
    arch = ARCHS[args.model]
    params = P.init_params(arch, args.seed, dtype=_dtype(args),
                           device=_device(args))
    return params, arch


def _load_data(args, arch):
    from .evaluation.data import prepare_datasets

    datasets = prepare_datasets(num_cal=args.calibration_samples,
                                num_test=args.samples, seed=args.seed,
                                use_librispeech=args.librispeech,
                                audio_dir=getattr(args, "audio_dir", None),
                                transcripts=getattr(args, "transcripts",
                                                    None))
    return datasets, _tokenizer(args, arch)


def _apply_quant_arg(params, arch, name: str, args,
                     datasets=None, tok=None):
    """Apply a --quant name: REGISTRY configs directly; DATA_AWARE ones
    (GPTQ/SmoothQuant/AWQ) via an eager calibration callable built from the
    loaded calibration split (or a small synthetic set when none is)."""
    from .evaluation.harness import make_calibration_fn
    from .quant import api as quant_api

    if name not in quant_api.DATA_AWARE:
        return quant_api.apply_named_config(params, name)
    if datasets is not None:
        cal = datasets.get("calibration_clean") or []
    else:
        from .evaluation.data import synthetic_dataset

        cal = synthetic_dataset(4, seed=args.seed)
    run_cal = make_calibration_fn(
        arch, cal, tok, batch_size=min(getattr(args, "batch_size", 4), 4),
        device=_device(args))
    return quant_api.quantize_data_aware(params, arch, name, run_cal)


def _normalizer_for(args) -> str:
    """--normalizer wins; otherwise real DATA (--librispeech/--audio-dir)
    scores under the reference's full Whisper normalizer
    (`data_utils.py:60,170`), while the synthetic token set keeps the basic
    normalizer (the number normalizer rewrites ids like "w1" — so --hf
    alone, which only changes the WEIGHTS, must not flip the scoring)."""
    explicit = getattr(args, "normalizer", None)
    if explicit:
        return explicit
    real_data = (getattr(args, "librispeech", False)
                 or getattr(args, "audio_dir", None))
    return "whisper" if real_data else "basic"


def _decode_cfg(args, arch):
    from .config import DecodeConfig

    # language/task default to "auto": forced_prefix resolves the per-arch
    # ids (v2 vs v3 layouts differ; `.en` vocabs omit them entirely)
    kw = {}
    if getattr(args, "task", "transcribe") == "translate":
        kw["task_token_id"] = arch.task_translate_token_id
    if getattr(args, "language", None):
        from .config import language_token_id

        kw["language_token_id"] = language_token_id(arch, args.language)
    if getattr(args, "length_penalty", None) is not None:
        kw["length_penalty"] = args.length_penalty
    if getattr(args, "cross_kv_pool", None):
        kw["cross_kv_pool"] = args.cross_kv_pool
    if getattr(args, "cross_kv_merge", None):
        kw["cross_kv_merge"] = args.cross_kv_merge
    return DecodeConfig(max_new_tokens=args.max_new_tokens,
                        beam_size=args.beam,
                        notimestamps=arch.no_timestamps_token_id < arch.vocab_size,
                        kv_int8=args.kv_int8, **kw)


def cmd_evaluate(args):
    from .config import EvalConfig
    from .evaluation import harness
    from .evaluation.memory import MemoryTracker
    from .prune import recipe as recipe_mod

    params, arch = _load_model(args)
    datasets, tok = _load_data(args, arch)
    if args.prune_recipe:
        params = recipe_mod.apply_recipe(params, arch)
    if args.quant:
        params = _apply_quant_arg(params, arch, args.quant, args,
                                  datasets, tok)
    if getattr(args, "quant_config", None):
        from .quant import mixed

        qcfg = mixed.load_quant_config(args.quant_config)
        params = mixed.apply_quant_config(params, qcfg)
        print(f"mixed-precision: avg {qcfg['avg_bits']} bits "
              f"({qcfg['counts']})")
    tracker = MemoryTracker(f"{arch.name}_{args.quant or 'dense'}")
    scores, records = harness.evaluate_model(
        params, arch, datasets["test_clean"], tok,
        eval_cfg=EvalConfig(batch_size=args.batch_size,
                            split="test_clean",
                            normalizer=_normalizer_for(args)),
        decode_cfg=_decode_cfg(args, arch), memory_tracker=tracker,
        device=_device(args))
    if args.save_path:
        harness.save_evaluation_results(scores, records, arch.name,
                                        args.save_path)
    harness.print_evaluation_summary({f"{arch.name}": scores})
    return scores


def cmd_sweep(args):
    from .config import EvalConfig
    from .sweep import plots
    from .sweep.configs import SWEEPS
    from .sweep.driver import (merge_host_results, run_sweep, shard_configs,
                               summarize)

    if args.merge_hosts:
        merged = merge_host_results(args.save_path or ".")
        summarize(merged)
        return merged
    params, arch = _load_model(args)
    datasets, tok = _load_data(args, arch)
    configs = SWEEPS[args.sweep](arch)
    if args.limit:
        configs = configs[: args.limit]
    if args.host_shard:
        from .parallel import multihost

        info = multihost.initialize()
        configs = shard_configs(configs)
        if args.save_path:
            args.save_path = os.path.join(
                args.save_path, f"host{info.get('process_id', 0)}")
        print(f"host shard: {len(configs)} configs on process "
              f"{info.get('process_id', 0)}/{info['processes']}")
    results = run_sweep(params, arch, configs, datasets, tok,
                        eval_cfg=EvalConfig(batch_size=args.batch_size,
                                            normalizer=_normalizer_for(args)),
                        decode_cfg=_decode_cfg(args, arch),
                        save_path=args.save_path,
                        resume=not args.no_resume, device=_device(args))
    summarize(results)
    if args.save_path and _can_plot():
        plots.plot_sweep(results, args.save_path, prefix=args.sweep)
        plots.plot_metric_curves(results, args.save_path,
                                 prefix=f"{args.sweep}_curve")
    return results


def _can_plot() -> bool:
    """Whether matplotlib is installed; where it is not (the card's
    machine), the sub-commands that plot say so and write their JSON/CSV
    only."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("# matplotlib is not installed: no plots written")
        return False
    return True


def cmd_sensitivity(args):
    from .sensitivity import gradient, heads, recommend

    params, arch = _load_model(args)
    if args.use_dataset:
        from .evaluation.data import synthetic_dataset
        from .evaluation.tokenizer import default_tokenizer

        data = synthetic_dataset(args.batches * args.batch_size, seed=args.seed)
        tok = default_tokenizer(arch)
        batches = gradient.batches_from_dataset(arch, data, tok,
                                                batch=args.batch_size,
                                                device=_device(args))
    else:
        batches = gradient.make_synthetic_batches(
            arch, n_batches=args.batches, batch=args.batch_size, seq=16)
    if args.method in ("gradient", "fisher"):
        scores = gradient.compute_sensitivity(
            params, arch, batches, power=1.0 if args.method == "gradient" else 2.0)
        if getattr(args, "quant_bits", None):
            from .quant import mixed

            qcfg = mixed.generate_quant_config(
                params, scores, target_bits=args.quant_bits,
                ladder=tuple(m.strip() for m in args.quant_ladder.split(",")
                             if m.strip()))
            print(json.dumps({k: qcfg[k] for k in
                              ("avg_bits", "target_bits", "counts")},
                             indent=2))
            if args.save_path:
                mixed.save_quant_config(qcfg, args.save_path)
                print(f"mixed-precision quant config -> {args.save_path}")
            return qcfg
        cfg = recommend.generate_pruning_config(scores, arch)
        print(json.dumps(cfg["analysis"]["by_category"], indent=2))
        if args.save_path:
            from .sensitivity.plots import plot_sensitivity

            recommend.save_pruning_config(cfg, args.save_path)
            if _can_plot():
                plot_sensitivity(cfg["analysis"],
                                 os.path.dirname(args.save_path) or ".",
                                 prefix=args.method)
            print(f"pruning config -> {args.save_path}")
        return cfg
    if args.method == "heads":
        imp = heads.head_importance(params, arch, batches, kind=args.attn_kind)
        print(json.dumps({"importance": imp.tolist()}, indent=2))
        return imp
    raise SystemExit(f"unknown method {args.method}")


def cmd_run(args):
    """Execute a RunConfig JSON (the unified experiment schema replacing the
    reference's three config styles — SURVEY.md §5 'Config / flag system')."""
    from .config import RunConfig
    from .evaluation import harness
    from .evaluation.memory import MemoryTracker

    rc = RunConfig.from_json(open(args.config).read())
    args.model, args.dtype = rc.model, rc.dtype
    params, arch = _load_model(args)
    teacher = params            # uncompressed: the recovery target

    if rc.pruning:
        if "recipe" in rc.pruning:
            from .prune.recipe import apply_recipe

            params = apply_recipe(params, arch, rc.pruning["recipe"])
        if "global_l1" in rc.pruning:
            from .prune.magnitude import prune_global_l1

            params = prune_global_l1(params, rc.pruning["global_l1"])
    args.samples = rc.eval.num_samples
    args.calibration_samples = 4
    args.librispeech = getattr(args, "librispeech", False)
    datasets, tok = _load_data(args, arch)

    if rc.recovery:
        r = dict(rc.recovery)
        qat, steps = r.pop("qat", False), r.pop("steps", 50)
        lr = r.pop("lr", 3e-5)
        if r:
            raise SystemExit(f"unknown recovery keys {sorted(r)}; "
                             "schema: {qat, steps, lr}")
        params, hist, label = _run_recovery_ladder(
            params, teacher, arch, qat=qat, steps=steps, lr=lr,
            quant=rc.quantization, pruned=bool(rc.pruning))
        print(f"recovery loss {hist[0]:.4f} -> {hist[-1]:.4f} "
              f"({steps} steps, {label})")

    if rc.quantization and not rc.recovery:
        from .quant import api as quant_api

        if "mixed_config" in rc.quantization:
            # path to a sensitivity --quant-bits artifact
            from .quant import mixed

            params = mixed.apply_quant_config(
                params, mixed.load_quant_config(
                    rc.quantization["mixed_config"]))
        elif "name" in rc.quantization:
            # REGISTRY or DATA_AWARE name (data-aware calibrates on the
            # loaded calibration split)
            params = _apply_quant_arg(params, arch,
                                      rc.quantization["name"], args,
                                      datasets, tok)
        else:
            params = quant_api.quantize_params(params, **rc.quantization)

    tracker = MemoryTracker(f"run_{rc.model}")
    scores, records = harness.evaluate_model(
        params, arch, datasets["test_clean"][: rc.eval.num_samples], tok,
        eval_cfg=rc.eval, decode_cfg=rc.decode, memory_tracker=tracker,
        device=_device(args))
    if rc.eval.save_path:
        harness.save_evaluation_results(scores, records, rc.model,
                                        rc.eval.save_path)
    harness.print_evaluation_summary({rc.model: scores})
    return scores


def _transcribe_continuous(args):
    """`transcribe --continuous`: --audio is a DIRECTORY; every file runs
    through the continuous-batching slot pool (continuous.py) — finished
    utterances retire and the next file is admitted mid-flight, so the
    corpus pays the SUM of decode lengths instead of waves x max."""
    import sys

    from .continuous import CBStats, ContinuousBatcher
    from .evaluation.data import load_audio_dir

    params, arch = _load_model(args)
    utts = load_audio_dir(args.audio, transcripts=getattr(
        args, "transcripts", None))
    tok = _tokenizer(args, arch)
    cfg = _decode_cfg(args, arch)
    # the overlapped loop hides the per-chunk read-back behind the next
    # chunk on the card; on the CPU there is nothing to hide
    dev = torch.device(_device(args))
    cb = ContinuousBatcher(params, arch, cfg, batch=args.cb_slots,
                           chunk=args.cb_chunk,
                           admit_lanes=max(2, args.cb_slots // 2),
                           overlap=dev.type == "cuda", device=dev)
    # the slot pool decodes single 30 s windows (plan.n_samples); longer
    # recordings would be silently truncated by the padder — route users
    # to the chunking TranscriptionService / longform path instead
    too_long = [u.uid for u in utts if len(u.audio) > cb.plan.n_samples]
    if too_long:
        cap_s = cb.plan.n_samples / 16000.0
        print(f"# WARNING: {len(too_long)} file(s) exceed the {cap_s:.0f}s "
              f"continuous-batching window and will be truncated "
              f"(first: {too_long[0]}); use `transcribe` without "
              f"--continuous (longform seek) for long recordings",
              file=sys.stderr)
    stats = CBStats()
    seqs = cb.transcribe_all([u.audio for u in utts], stats=stats)
    p_len, eot = cb.plan.p_len, arch.eos_token_id
    results = []
    for u, seq in zip(utts, seqs):
        ids = [int(t) for t in seq[p_len:] if int(t) != eot]
        text = tok.decode(ids)
        results.append({"uid": u.uid, "text": text})
        print(f"{u.uid}\t{text}")
    print(f"# continuous-batching stats: {stats.snapshot()}",
          file=sys.stderr)
    return results


def cmd_transcribe(args):
    """Transcribe an audio file (.flac, .wav 16-bit PCM, or .npy float
    waveform)."""
    import numpy as np

    from . import transcribe
    from .evaluation.data import read_audio_file

    if getattr(args, "continuous", False):
        return _transcribe_continuous(args)
    wav = read_audio_file(args.audio, assume_rate=args.sample_rate)

    params, arch = _load_model(args)
    if getattr(args, "stream", False):
        # simulate live streaming from the file: feed chunk_s-sized pieces,
        # print committed/pending partials as they stabilize
        import dataclasses

        from .streaming import StreamingTranscriber

        tok = _tokenizer(args, arch)
        cfg = dataclasses.replace(_decode_cfg(args, arch), notimestamps=False)
        st = StreamingTranscriber(params, arch, tok, cfg,
                                  min_step_s=args.stream_chunk_s,
                                  device=_device(args))
        step = int(args.stream_chunk_s * 16000)
        for i in range(0, len(wav), step):
            out = st.feed(wav[i: i + step])
            print(f"[{(i + step) / 16000.0:6.1f}s] {out['committed']} "
                  f"| {out['pending']}")
        final = st.flush()
        print(final["committed"])
        return final
    temps = None
    if getattr(args, "temperatures", None):
        temps = tuple(float(t) for t in args.temperatures.split(","))
    cond = getattr(args, "condition_on_previous", False)
    if args.timestamps or args.word_timestamps:
        import dataclasses

        from .evaluation.longform import transcribe_seek

        tok = _tokenizer(args, arch)
        cfg = dataclasses.replace(_decode_cfg(args, arch), notimestamps=False)
        hst = getattr(args, "hallucination_silence_threshold", None)
        seed_ids = None
        if getattr(args, "initial_prompt", None):
            # with conditioning: seeds the rolling context; without: the
            # first window only (OpenAI prompt reset) — never dropped
            seed_ids = list(tok.encode(args.initial_prompt))
        res = transcribe_seek(params, arch, wav, tok, cfg,
                              word_timestamps=(args.word_timestamps
                                               or hst is not None),
                              clip_timestamps=getattr(
                                  args, "clip_timestamps", None),
                              hallucination_silence_threshold=hst,
                              temperatures=temps,
                              condition_on_previous=cond,
                              initial_prompt_ids=seed_ids,
                              device=_device(args))
        for s in res["segments"]:
            end = "?" if s["end"] is None else f"{s['end']:.2f}"
            print(f"[{s['start']:.2f} -> {end}] {s['text']}")
        for w in res.get("words", []):
            print(f"  {w['start']:.2f}-{w['end']:.2f} {w['word']}")
    elif args.draft_model:
        from . import load_model
        from .config import ARCHS
        from .evaluation.harness import (make_speculative_transcribe_fn,
                                         samples_for_arch)
        from .models import params as P
        from .models.decode import forced_prefix

        if getattr(args, "hf", None):
            # target came from an HF checkpoint -> the draft must too, or
            # acceptance is ~0% and speculation is strictly slower
            params_d, arch_d = load_model(
                hf=f"openai/whisper-{args.draft_model}", dtype=_dtype(args),
                device=_device(args))
        else:
            arch_d = ARCHS[args.draft_model]
            params_d = P.init_params(arch_d, args.seed, device=_device(args))
        cfg = _decode_cfg(args, arch)
        fn = make_speculative_transcribe_fn(arch, arch_d, cfg,
                                            gamma=args.gamma,
                                            device=_device(args))
        n = samples_for_arch(arch)
        buf = np.zeros((1, n), np.float32)
        buf[0, : min(len(wav), n)] = wav[:n]
        tokens, lengths = fn(params, params_d, buf)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        ids = tokens[0, len(forced_prefix(arch, cfg)): lengths[0]]
        ids = ids[ids != arch.eos_token_id]
        tok = _tokenizer(args, arch)
        res = {"text": tok.decode(ids.tolist()), "tokens": ids.tolist()}
        print(res["text"])
    else:
        res = transcribe(params, arch, wav,
                         decode_cfg=_decode_cfg(args, arch),
                         batch_size=args.batch_size,
                         temperatures=temps,
                         best_of=getattr(args, "best_of", 1),
                         condition_on_previous=cond,
                         initial_prompt=getattr(args, "initial_prompt", None),
                         device=_device(args))
        print(res["text"])
    if getattr(args, "output_format", None):
        from .utils.writers import get_writer

        writer = get_writer(args.output_format, args.output_dir)
        for path in writer(res, args.audio, duration=len(wav) / 16000.0):
            print(f"wrote {path}")
    return res


def cmd_agreement(args):
    """Token/logit agreement of a compressed model vs its dense baseline."""
    import numpy as np

    from .audio import features
    from .evaluation.agreement import model_agreement
    from .evaluation.data import synthetic_dataset
    from .evaluation.harness import _tree_dtype, samples_for_arch

    params, arch = _load_model(args)
    comp = _apply_quant_arg(params, arch, args.quant, args)
    if args.prune_recipe:
        from .prune import recipe as recipe_mod

        comp = recipe_mod.apply_recipe(comp, arch)
    n = samples_for_arch(arch)
    data = synthetic_dataset(args.samples, seed=args.seed)
    wav = np.zeros((args.samples, n), np.float32)
    for i, u in enumerate(data):
        m = min(len(u.audio), n)
        wav[i, :m] = u.audio[:m]
    # in the tree's type (f32 for the default --dtype, as the JAX CLI's):
    # the decode's caches take the encoder's dtype
    mels = features.preprocess(torch.from_numpy(wav).to(_device(args)),
                               arch.num_mel_bins, length=n).to(_tree_dtype(params))
    res = model_agreement(params, comp, arch, mels)
    print(json.dumps({"quant": args.quant, **res}, indent=2))
    return res


def cmd_presets(args):
    """Run the BASELINE.json headline presets end-to-end."""
    from .config import EvalConfig
    from .evaluation import harness
    from .evaluation.memory import MemoryTracker
    from .sweep.presets import BASELINE_PRESETS, PRESETS

    if args.preset and args.preset not in PRESETS:
        raise SystemExit(f"unknown preset {args.preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    presets = ([PRESETS[args.preset]] if args.preset else BASELINE_PRESETS)
    all_scores = {}
    for preset in presets:
        params, arch, dcfg = preset.build(arch_override=args.arch_override,
                                          seed=args.seed, device=_device(args))
        import dataclasses

        dcfg = dataclasses.replace(dcfg, max_new_tokens=args.max_new_tokens)
        datasets, tok = _load_data(args, arch)
        tracker = MemoryTracker(preset.name)
        scores, _ = harness.evaluate_model(
            params, arch, datasets["test_clean"], tok,
            eval_cfg=EvalConfig(batch_size=args.batch_size),
            decode_cfg=dcfg, memory_tracker=tracker, device=_device(args))
        if preset.longform:
            from . import transcribe
            import numpy as np

            long_wav = np.concatenate(
                [u.audio for u in datasets["test_clean"][:4]])
            res = transcribe(params, arch, long_wav, tok, decode_cfg=dcfg,
                             batch_size=args.batch_size, device=_device(args))
            scores["longform_chunks"] = res["num_chunks"]
        all_scores[preset.name] = scores
    harness.print_evaluation_summary(all_scores)
    return all_scores


def cmd_curve(args):
    """Compression->speed curve artifact: sweep the structured ladder
    (head-prune 25/50%, FFN shrink, decoder layer drop, each + quant,
    optional recovery distill) ON-CHIP, emitting RTFx + agreement + size
    per point (JSON + plot) — the thesis's core story told with measured
    throughput, which masked-pruning torch could not do
    (`pruning_quantization_all.py:1392-1460` reports theoretical GFLOPs).
    The ladder runs on the tree's device, the card by default."""
    from .sweep.curve import plot_curve, run_curve

    params, arch = _load_model(args)

    on_point = None
    if args.save_path:
        os.makedirs(args.save_path, exist_ok=True)

        def on_point(pts):
            # incremental write: a failure late in the ladder must not
            # lose the completed rungs
            with open(os.path.join(args.save_path, "curve.json"), "w") as f:
                json.dump({"model": arch.name, "batch": args.batch_size,
                           "quant": args.quant or "int8",
                           "dtype": args.dtype, "partial": True,
                           "points": pts}, f, indent=2)

    points = run_curve(params, arch, quant=args.quant or "int8",
                       batch=args.batch_size, tokens=args.max_new_tokens,
                       iters=args.iters, recover_steps=args.recover_steps,
                       on_point=on_point)
    out = {"model": arch.name, "batch": args.batch_size,
           "quant": args.quant or "int8", "dtype": args.dtype,
           "points": points}
    if args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        jpath = os.path.join(args.save_path, "curve.json")
        with open(jpath, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {jpath}")
        if _can_plot():
            ppath = os.path.join(args.save_path, "curve.png")
            plot_curve(points, ppath)
            print(f"wrote {ppath}")
    print(json.dumps(out))
    return out


def cmd_analyze(args):
    from .sensitivity import architecture

    params, arch = _load_model(args)
    a = architecture.analyze_model(params)
    print(architecture.format_table(a))
    if args.save_path:
        architecture.to_csv(a, args.save_path)
        print(f"csv -> {args.save_path}")
    return a


def _run_recovery_ladder(student, teacher, arch, *, qat: bool, steps: int,
                         lr: float, quant: dict | None, pruned: bool = False,
                         **distill_kw):
    """The one compression-recovery ladder (shared by `distill` and
    `run` so the two CLI surfaces cannot drift):

      quant + qat   -> STE QAT (fake-quant forwards, requant latent)
      quant, no qat -> PTQ -> recover -> requant (error baked into dense
                       weights so distillation has a real gap to close)
      no quant      -> plain recovery distillation (pruned students)

    `quant` is the full quantization spec dict ({"name"|"method", "act",
    "include_embed", + quantizer kwargs}) — every key is honoured on the
    final requant, not just the method name.

    `pruned` says whether `student` carries pruning masks worth freezing:
    sparsity is preserved ONLY then, and the masks always come from the
    PRE-quantization student — never from zeros the quantizer rounded in
    (at int2/int3 those are a large weight fraction, and freezing them
    would silently cripple recovery; matches `fake_quant_recovery`).

    Returns (params, loss_history, label)."""
    from .distill import distill as run_distill

    if steps < 1:
        raise SystemExit(f"recovery steps must be >= 1, got {steps}")
    if qat and not quant:
        raise SystemExit("QAT needs a quantization method "
                         "(--quant / quantization.name)")
    # an explicit caller preserve_sparsity/sparsity_ref wins over the
    # `pruned`-derived defaults
    ps = distill_kw.pop("preserve_sparsity", pruned)
    sref = distill_kw.pop("sparsity_ref",
                          student if (ps and pruned) else None)
    if quant is None:
        out, hist = run_distill(student, teacher, arch, steps=steps, lr=lr,
                                preserve_sparsity=ps, **distill_kw)
        return out, hist, "recovery"
    from .quant.api import dequantize_params, quantize_params
    from .quant.qat import make_ste_transform, resolve_method

    spec = dict(quant)
    if "mixed_config" in spec:
        raise SystemExit("recovery does not compose with mixed_config")
    method = spec.pop("name", None) or spec.pop("method", None)
    spec.pop("method", None)
    if not method:
        raise SystemExit("recovery needs quantization name/method (a "
                         "QUANTIZERS or weight-quant REGISTRY entry)")
    act = spec.pop("act", None)
    include_embed = bool(spec.pop("include_embed", False))
    base_method, qkw = resolve_method(method, spec)   # fail fast
    if qat:
        transform = make_ste_transform(student, base_method,
                                       include_embed, **qkw)
        latent, hist = run_distill(student, teacher, arch, steps=steps,
                                   lr=lr, param_transform=transform,
                                   preserve_sparsity=ps, **distill_kw)
    else:
        dense = dequantize_params(quantize_params(
            student, base_method, include_embed=include_embed, **qkw))
        latent, hist = run_distill(dense, teacher, arch, steps=steps,
                                   lr=lr, preserve_sparsity=ps,
                                   sparsity_ref=sref, **distill_kw)
    out = quantize_params(latent, base_method, act=act,
                          include_embed=include_embed, **qkw)
    return out, hist, ("QAT" if qat else "recovery")


def cmd_distill(args):
    """Recovery fine-tuning: prune and/or quantize, then KL-distill the
    compressed student against its own uncompressed teacher (no labels
    needed). --qat runs true STE quantization-aware training
    (`quant/qat.py`); --quant without --qat runs the PTQ->recover->requant
    ladder (`distill.fake_quant_recovery` semantics, history surfaced)."""
    from .prune.magnitude import prune_global_l1, sparsity_report
    from .quant.api import dequantize_params

    params, arch = _load_model(args)
    teacher = params
    student = prune_global_l1(teacher, args.prune) if args.prune else teacher
    out, history, label = _run_recovery_ladder(
        student, teacher, arch, qat=args.qat, steps=args.steps, lr=args.lr,
        quant={"name": args.quant} if args.quant else None,
        pruned=bool(args.prune),
        batch=args.distill_batch, seq_len=args.seq_len, seed=args.seed)
    print(f"distill loss {history[0]:.4f} -> {history[-1]:.4f} "
          f"({args.steps} steps, {label})")
    if args.prune:
        # QTensor leaves are opaque to the sparsity walk — report on the
        # dequantized values, where the pruned zeros actually live
        rep = sparsity_report(dequantize_params(out))
        print(f"sparsity preserved: {rep['overall_sparsity']:.3f}")
    if args.save_path:
        from .storage import formats

        save, _ = formats.FORMATS[args.format]
        stats = save(out, args.save_path)
        print(f"saved {args.save_path} ({stats['file_mb']:.1f} MB)")


def cmd_export(args):
    """Export a (optionally compressed) model as an HF-named state dict:
    .npz (numpy), .pt (torch.save), or .safetensors (the framework's own
    dependency-free writer; loads straight back via `--weights` or any HF
    tool) — the counterpart of the reference's `save_pretrained` flow
    (`openai_whisper_compression/utils.py:258-268`) so compressed models
    round-trip into HF-based tooling. Quantized leaves are dequantized
    (fake-quant values, error baked in)."""
    from .models.convert import to_hf_state_dict
    from .quant.api import dequantize_params
    from .storage import formats

    if args.load:
        params = None
        for kind in ("npz", "sparse_zip", "gzip"):
            try:
                params = formats.FORMATS[kind][1](args.load,
                                                  device=_device(args))
                break
            except Exception:
                continue
        if params is None:
            raise SystemExit(f"could not load {args.load} with any of "
                             f"{sorted(formats.FORMATS)}")
        from .config import ARCHS

        arch = ARCHS[args.model]
    else:
        params, arch = _load_model(args)
    if args.quant:
        # applies to --load models too (quantize_params skips leaves that
        # are already QTensors, so re-export of a stored quantized model
        # composes instead of silently dropping the flag)
        params = _apply_quant_arg(params, arch, args.quant, args)
    sd = to_hf_state_dict(dequantize_params(params))
    import numpy as np

    out_path = args.out
    if out_path.endswith(".pt"):
        torch.save(sd, out_path)
    elif out_path.endswith(".safetensors"):
        from .models.convert import write_safetensors

        write_safetensors(sd, out_path)
    else:
        if not out_path.endswith(".npz"):
            out_path += ".npz"
        np.savez(out_path, **{k: v.numpy() for k, v in sd.items()})
    n = sum(v.numel() for v in sd.values())
    print(f"exported {len(sd)} tensors / {n:,} params "
          f"({arch.name}) -> {out_path}")


def cmd_compress(args):
    from .prune import magnitude, recipe as recipe_mod
    from .storage import formats

    params, arch = _load_model(args)
    rec = recipe_mod.INCREASED_RECIPE if args.increase_pruning else None
    pruned = recipe_mod.apply_recipe(params, arch, rec)
    if args.quant:
        pruned = _apply_quant_arg(pruned, arch, args.quant, args)
    rep = magnitude.sparsity_report(pruned)
    print(f"sparsity: {rep['overall_sparsity']:.3f}  "
          f"nnz: {rep['nonzero_params']:,}")
    if args.verify:
        res = formats.verify_roundtrip(pruned, args.save, args.format)
        status = "OK" if res["ok"] else f"MISMATCH {res['mismatches'][:3]}"
        print(f"saved {args.save} ({res['file_mb']:.1f} MB) roundtrip {status}")
    else:
        save, _ = formats.FORMATS[args.format]
        stats = save(pruned, args.save)
        print(f"saved {args.save} ({stats['file_mb']:.1f} MB)")


_FORMATS = ["sparse_zip", "gzip", "npz"]   # storage.formats.FORMATS' keys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="openai_whisper_compression_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--model", default="tiny")
        p.add_argument("--hf", default=None,
                       help="HF model name/path (needs hub or cache)")
        p.add_argument("--weights", default=None,
                       help="local checkpoint: HF snapshot/export dir, "
                            "OpenAI original .pt, bare torch state dict, "
                            "or bare .safetensors (arch inferred)")
        p.add_argument("--dtype", default="float32")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--batch-size", type=int, default=4)
        p.add_argument("--save-path", default=None)
        p.add_argument("--device", default="cuda",
                       help="torch device the model runs on (the card by "
                            "default; cpu runs every kernel's plain version)")

    def data_opts(p):
        p.add_argument("--samples", type=int, default=8)
        p.add_argument("--normalizer", default=None,
                       choices=["whisper", "basic", "none"],
                       help="WER/CER text normalization (default: whisper "
                            "for real data via --librispeech/--hf, basic "
                            "for the synthetic set)")
        p.add_argument("--calibration-samples", type=int, default=4)
        p.add_argument("--librispeech", action="store_true")
        p.add_argument("--audio-dir", default=None,
                       help="local dir of .flac/.wav/.npy (+ *.trans.txt / "
                            "sidecar .txt transcripts): real-audio WER "
                            "with zero egress — an unpacked LibriSpeech "
                            "split works verbatim")
        p.add_argument("--transcripts", default=None,
                       help="uid<TAB>text table for --audio-dir")
        p.add_argument("--max-new-tokens", type=int, default=32)
        p.add_argument("--beam", type=int, default=1)
        p.add_argument("--length-penalty", type=float, default=None,
                       help="beam-score length exponent (len^alpha; "
                            "HF/OpenAI length_penalty semantics)")
        p.add_argument("--kv-int8", action="store_true")
        p.add_argument("--cross-kv-pool", type=int, default=None,
                       help="mean-pool encoder frames with this stride "
                            "before cross-KV (lossy; 2 halves the decode "
                            "cross-attention stream — models/merge.py)")
        p.add_argument("--cross-kv-merge", type=int, default=None,
                       help="ToMe-style bipartite merge of this many "
                            "encoder frame pairs before cross-KV "
                            "(content-adaptive lossy token merging)")

    p = sub.add_parser("evaluate", help="single-config evaluation")
    common(p)
    data_opts(p)
    p.add_argument("--quant", default=None)
    p.add_argument("--quant-config", default=None,
                   help="mixed-precision config JSON from "
                        "`sensitivity --quant-bits`")
    p.add_argument("--prune-recipe", action="store_true")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("sweep", help="config-matrix sweep")
    common(p)
    data_opts(p)
    p.add_argument("--sweep", default="quant",
                   choices=["quant", "l1", "random", "experimental",
                            "prune_quant", "data_aware", "mixed",
                            "recovery"])
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--no-resume", action="store_true",
                   help="rerun configs already present in all_results.json")
    p.add_argument("--host-shard", action="store_true",
                   help="multi-host fan-out: this process runs its "
                        "round-robin share of configs (torch.distributed), "
                        "writing under <save-path>/host<i>/")
    p.add_argument("--merge-hosts", action="store_true",
                   help="merge <save-path>/host*/all_results.json and exit")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("run", help="execute a RunConfig JSON experiment")
    common(p)
    p.add_argument("--config", required=True)
    p.add_argument("--librispeech", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("transcribe",
                       help="transcribe a .flac/.wav/.npy file")
    common(p)
    data_opts(p)
    p.add_argument("--audio", required=True)
    p.add_argument("--sample-rate", type=int, default=16000,
                   help="sample rate for .npy inputs")
    p.add_argument("--stream", action="store_true",
                   help="simulate live streaming: feed the file in "
                        "--stream-chunk-s pieces, print stable partials "
                        "(LocalAgreement commitment)")
    p.add_argument("--stream-chunk-s", type=float, default=1.0)
    p.add_argument("--continuous", action="store_true",
                   help="--audio is a DIRECTORY: transcribe every file "
                        "through the continuous-batching slot pool "
                        "(slot recycling; greedy, no timestamps; prints "
                        "uid<TAB>text per file)")
    p.add_argument("--cb-slots", type=int, default=8,
                   help="--continuous decode slot pool size")
    p.add_argument("--cb-chunk", type=int, default=8,
                   help="--continuous decode steps between retire/admit")
    p.add_argument("--timestamps", action="store_true",
                   help="segment timestamps via seek decoding")
    p.add_argument("--word-timestamps", action="store_true",
                   help="word-level times via cross-attention DTW")
    p.add_argument("--clip-timestamps", default=None,
                   help="'start,end,start,end,...' seconds to transcribe "
                        "(OpenAI clip_timestamps; needs --timestamps)")
    p.add_argument("--hallucination-silence-threshold", type=float,
                   default=None,
                   help="drop hallucinated segments surrounded by more "
                        "than this many seconds of silence (OpenAI parity; "
                        "implies word timestamps)")
    p.add_argument("--draft-model", default=None,
                   help="speculative decoding with this draft arch "
                        "(e.g. tiny drafting for small; output is exactly "
                        "the target's greedy transcript)")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft tokens per speculative round")
    p.add_argument("--temperatures", default=None,
                   help="comma list, e.g. '0,0.2,0.4,0.6,0.8,1.0': OpenAI "
                        "temperature-fallback ladder with compression-ratio"
                        "/logprob quality gates (models.fallback)")
    p.add_argument("--best-of", type=int, default=1,
                   help="candidates sampled per sequence at each t>0 "
                        "fallback rung; best mean-logprob wins (OpenAI "
                        "DecodingOptions.best_of)")
    p.add_argument("--initial-prompt", default=None,
                   help="text fed as the first window's decoder prompt "
                        "(OpenAI initial_prompt)")
    p.add_argument("--condition-on-previous", action="store_true",
                   help="rolling previous-text decoder prompt (OpenAI "
                        "condition_on_previous_text; chunked and "
                        "timestamps/seek paths)")
    p.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--language", default=None,
                   help="source language code (e.g. de) or raw token id")
    p.add_argument("--output-format", "-f", default=None,
                   choices=["txt", "json", "srt", "vtt", "tsv", "all"],
                   help="also write the result to --output-dir in this "
                        "format (OpenAI whisper --output_format parity)")
    p.add_argument("--output-dir", "-o", default=".",
                   help="directory for --output-format files")
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("agreement", help="compressed-vs-baseline agreement")
    common(p)
    p.add_argument("--quant", default="quanto_int8")
    p.add_argument("--prune-recipe", action="store_true")
    p.add_argument("--samples", type=int, default=4)
    p.set_defaults(fn=cmd_agreement)

    p = sub.add_parser("presets", help="run BASELINE headline presets")
    common(p)
    data_opts(p)
    p.add_argument("--preset", default=None)
    p.add_argument("--arch-override", default=None,
                   help="run preset transforms on a different (tiny) arch")
    p.set_defaults(fn=cmd_presets)

    p = sub.add_parser("curve", help="compression->speed ladder artifact "
                                     "(on-chip RTFx + agreement + size)")
    common(p)
    p.add_argument("--max-new-tokens", type=int, default=25)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--recover-steps", type=int, default=0,
                   help="> 0 adds a +recover distilled variant per lossy "
                        "rung")
    p.add_argument("--quant", default="int8",
                   help="weight quantizer applied at every non-dense rung")
    p.set_defaults(fn=cmd_curve)

    p = sub.add_parser("sensitivity", help="sensitivity analyses")
    common(p)
    p.add_argument("--method", default="gradient",
                   choices=["gradient", "fisher", "heads"])
    p.add_argument("--attn-kind", default="encoder",
                   choices=["encoder", "decoder", "cross"])
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--use-dataset", action="store_true",
                   help="derive batches from utterances instead of noise")
    p.add_argument("--quant-bits", type=float, default=None,
                   help="emit a mixed-precision quant config at this "
                        "param-weighted average bit-width instead of a "
                        "pruning config")
    p.add_argument("--quant-ladder", default="int4,int8",
                   help="comma list of quant methods, ascending bits")
    p.set_defaults(fn=cmd_sensitivity)

    p = sub.add_parser("analyze", help="architecture introspection")
    common(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("distill",
                       help="recovery distillation / QAT fine-tuning")
    common(p)
    p.add_argument("--quant", default=None,
                   help="quantizer method (QUANTIZERS name, e.g. int2)")
    p.add_argument("--qat", action="store_true",
                   help="STE quantization-aware training (needs --quant)")
    p.add_argument("--prune", type=float, default=None,
                   help="global L1 prune amount before distilling")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--distill-batch", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--format", default="npz",
                   choices=_FORMATS)
    p.set_defaults(fn=cmd_distill)

    p = sub.add_parser("export",
                       help="export HF-named state dict "
                            "(.npz/.pt/.safetensors)")
    common(p)
    p.add_argument("--quant", default=None,
                   help="quantize before export (dequantized values land "
                        "in the state dict)")
    p.add_argument("--load", default=None,
                   help="load a stored compressed model (any storage "
                        "format) instead of --model/--hf weights")
    p.add_argument("--out", required=True,
                   help=".npz, .pt or .safetensors path")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("compress", help="thesis recipe + store compressed")
    common(p)
    p.add_argument("--quant", default=None)
    p.add_argument("--increase-pruning", action="store_true")
    p.add_argument("--save", required=True)
    p.add_argument("--format", default="sparse_zip",
                   choices=_FORMATS)
    p.add_argument("--verify", action="store_true")
    p.set_defaults(fn=cmd_compress)

    args = ap.parse_args(argv)
    from .utils.logging_setup import setup_logging

    setup_logging()
    return args.fn(args)


if __name__ == "__main__":
    main()
