"""Compression -> speed curve: structured compression measured as on-card
throughput.

The port of the JAX package's `sweep/curve.py`. Every rung is physical
surgery (smaller matmuls, smaller KV caches) or a decode-time lever, so
each point carries a measured RTFx beside its agreement with the dense
model and its stored size:

    dense -> int8 -> +head-prune 25% -> 50% -> +FFN shrink 50%
          -> +decoder layer drop      (each optionally + recovery distill)

The tree's device runs everything (the card unless the tree lives on the
CPU). The reference defect of the JAX module's `run_curve` is not copied:
there a `+recover` variant that fails adds a second point for a rung that
already has one; here the rung keeps its one point and the failure is
recorded on it (`point["recovered"] = {"name", "error"}`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..config import DecodeConfig, WhisperArch

Transform = Callable[[Any, WhisperArch], tuple[Any, WhisperArch]]


def _heads(amount: float):
    def f(p, a):
        from ..prune.structured import prune_heads_by_l1

        # the arch stays: head counts follow the weights' widths downstream
        return prune_heads_by_l1(p, a, amount, physical=True), a
    return f


def _ffn(amount: float):
    def f(p, a):
        from ..prune.structured import shrink_ffn

        for comp in ("encoder", "decoder"):
            for li in range(len(p[comp]["layers"])):
                p = shrink_ffn(p, comp, li, amount)
        return p, a
    return f


def _drop_decoder(frac: float):
    def f(p, a):
        from ..prune.structured import drop_layers

        n = len(p["decoder"]["layers"])
        k = max(1, int(n * frac))
        p = drop_layers(p, "decoder", list(range(n - k, n)))
        return p, a.replace(decoder_layers=n - k)
    return f


def _chain(*fns):
    def f(p, a):
        for fn in fns:
            p, a = fn(p, a)
        return p, a
    return f


def ladder(quant: str = "int8") -> list[tuple[str, Transform, bool, dict]]:
    """(name, transform, lossy, cfg_kw) rungs. Lossy rungs with no cfg_kw
    may take the recovery-distillation variant (the decode-time knobs, the
    cfg_kw rungs, have no weights to recover). cfg_kw are DecodeConfig
    overrides; "cross_kv_merge_frac" resolves to cross_kv_merge = frac x S
    at run time. The pool2 / tome rungs merge encoder tokens
    (`models/merge.py`), which shrinks the cross-KV every step reads."""
    ident: Transform = lambda p, a: (p, a)
    return [
        ("dense", ident, False, {}),
        (quant, ident, False, {}),
        (f"pool2+{quant}", ident, True, {"cross_kv_pool": 2}),
        (f"tome25%+{quant}", ident, True, {"cross_kv_merge_frac": 0.25}),
        (f"heads25+{quant}", _heads(0.25), True, {}),
        (f"heads50+{quant}", _heads(0.50), True, {}),
        (f"heads50+ffn50+{quant}", _chain(_heads(0.50), _ffn(0.50)), True, {}),
        (f"heads50+ffn50+pool2+{quant}",
         _chain(_heads(0.50), _ffn(0.50)), True, {"cross_kv_pool": 2}),
        (f"declayers-25%+{quant}", _drop_decoder(0.25), True, {}),
    ]


def _noise_mels(arch: WhisperArch, seed: int, count: int, n_samples: int,
                device) -> torch.Tensor:
    """f32 log-mels of 0.1-scaled white noise (`np.random.default_rng(seed)`,
    as the JAX module draws it)."""
    from ..audio import features

    rng = np.random.default_rng(seed)
    wav = torch.from_numpy((rng.standard_normal((count, n_samples)) * 0.1
                            ).astype(np.float32)).to(device)
    return features.preprocess(wav, arch.num_mel_bins, length=n_samples).float()


@torch.inference_mode()
def _recovery_pool(teacher, arch: WhisperArch, agree_cfg: DecodeConfig,
                   n_samples: int, pool: int = 32, seq_len: int = 16):
    """(mels (P, M, F), tokens (P, L), teacher logits (P, L, V)) numpy
    distillation pool: fresh noise mels (a seed apart from the agreement
    set's) and the dense teacher's greedy rollouts over them, cut to
    seq_len positions, with the teacher's logits computed once here (the
    teacher is frozen across every rung and step)."""
    from ..models.decode import greedy_decode
    from ..models.whisper import decode_logits, encode

    g = teacher["encoder"]["ln"]["g"]
    mels = _noise_mels(arch, 1234, pool, n_samples, g.device)
    toks, logits = [], []
    for i in range(0, pool, 8):
        enc = encode(teacher, arch, mels[i: i + 8].to(g.dtype))
        t16 = greedy_decode(teacher, arch, enc, agree_cfg)[0][:, :seq_len].long()
        toks.append(t16.cpu().numpy())
        logits.append(decode_logits(teacher, arch, t16, enc).float().cpu().numpy())
    return (mels.cpu().numpy(), np.concatenate(toks, axis=0),
            np.concatenate(logits, axis=0))


def _measure_rtfx(params, arch, cfg, batch: int, iters: int = 3,
                  avg_utt_s: float = 7.42) -> float:
    """Fixed-token decode throughput (bench.py's accounting: EOT suppressed,
    so every rung does the same token work), the median of `iters` walls
    each ended by the host readback of the tokens."""
    from ..evaluation.harness import make_transcribe_fn

    device = params["encoder"]["ln"]["g"].device
    fn = make_transcribe_fn(arch, cfg, fast_mel=True, device=device)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((batch, 480_000)) * 0.1
                            ).astype(np.float32)).to(device)
    fn(params, wav)[0].cpu()          # warmup (and the kernels' first build)
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(params, wav)[0].cpu()      # the readback ends the wall
        times.append(time.perf_counter() - t0)
    return batch * avg_utt_s / float(np.median(times))


def run_curve(params, arch: WhisperArch, *, quant: str = "int8",
              batch: int = 32, tokens: int = 25, iters: int = 3,
              agreement_samples: int = 8, recover_steps: int = 0,
              kv_int8: bool = True, cross_kv_int8: bool = True,
              rungs: list[str] | None = None,
              progress=print, on_point=None) -> list[dict]:
    """Measure every ladder rung on the tree's device.

    rungs: an optional name filter (substring match) selecting a subset.
    recover_steps > 0 adds a `+recover` variant to each lossy weight rung
    (KL distillation toward the dense teacher, then requantization).

    Returns one point dict a rung: {name, rtfx, size_mb, hbm_mb, params_m,
    token_agreement, top1_agreement, mean_kl, logit_rel_err,
    [recovered: {...}]}, or {name, error} for a rung that failed."""
    from ..evaluation.harness import samples_for_arch

    n = samples_for_arch(arch)
    g = params["encoder"]["ln"]["g"]
    mels = _noise_mels(arch, 1, agreement_samples, n, g.device).to(g.dtype)
    # plain transcription agreement (no timestamp rules) measures the same
    # compression fidelity
    agree_cfg = DecodeConfig(max_new_tokens=min(tokens, 16), language_token_id=None,
                             task_token_id=None, notimestamps=True)

    points: list[dict] = []
    pool_box: list = [None]   # the recovery pool, built at its first use
    for name, transform, lossy, cfg_kw in ladder(quant):
        if rungs is not None and not any(r in name for r in rungs):
            continue
        try:
            _run_rung(name, transform, lossy, cfg_kw, params, arch, quant, batch,
                      tokens, iters, recover_steps, kv_int8, cross_kv_int8,
                      agree_cfg, mels, n, points, progress, pool_box)
        except Exception as e:  # noqa: BLE001: one rung's failure keeps the sweep
            progress(f"# curve {name}: FAILED {e!r}")
            point = next((p for p in points if p["name"] == name), None)
            if point is None:
                points.append({"name": name, "error": repr(e)})
            else:   # the rung measured; its +recover variant failed
                point["recovered"] = {"name": name + "+recover", "error": repr(e)}
        if on_point is not None:
            on_point(points)
    return points


def _run_rung(name, transform, lossy, cfg_kw, params, arch, quant, batch,
              tokens, iters, recover_steps, kv_int8, cross_kv_int8,
              agree_cfg, mels, n, points, progress, pool_box) -> None:
    from ..evaluation.agreement import model_agreement
    from ..evaluation.memory import analytic_hbm_mb
    from ..models.params import leaf_count, size_in_mb
    from ..quant.api import quantize_params

    p2, a2 = transform(params, arch)
    ckw = dict(cfg_kw)
    frac = ckw.pop("cross_kv_merge_frac", None)
    if frac is not None:
        # the merge fraction of this arch's encoder length (bipartite cap r <= S / 2)
        s = a2.max_source_positions
        ckw["cross_kv_merge"] = min(int(s * frac), s // 2)
    variants = [("", p2)]
    if lossy and not cfg_kw and recover_steps > 0:
        from ..distill import distill

        # KL distillation toward the dense teacher on its own greedy
        # rollouts over fresh mels, in f32 (AdamW steps at lr 1e-4 sit
        # below bf16's resolution)
        if pool_box[0] is None:
            pool_box[0] = _recovery_pool(params, arch, agree_cfg, n, pool=32, seq_len=16)
        pool_m, pool_t, pool_l = pool_box[0]

        def batch_fn(r, _m=pool_m, _t=pool_t, _l=pool_l):
            idx = r.integers(0, _m.shape[0], size=8)
            return _m[idx], _t[idx], _l[idx]

        dense_rec, hist = distill(p2, params, a2, steps=recover_steps, lr=1e-4,
                                  temperature=1.0, batch_fn=batch_fn,
                                  preserve_sparsity=False, compute_dtype=torch.float32)
        progress(f"# curve {name}+recover: distill loss {hist[0]:.4f} -> "
                 f"{hist[-1]:.4f} ({recover_steps} steps)")
        variants.append(("+recover", dense_rec))
    base_entry = None
    for suffix, pv in variants:
        q = pv if name == "dense" else quantize_params(pv, quant)
        cfg = DecodeConfig(max_new_tokens=tokens, kv_int8=kv_int8,
                           cross_kv_int8=cross_kv_int8,
                           suppress_tokens=(arch.eos_token_id,), **ckw)
        rtfx = _measure_rtfx(q, a2, cfg, batch, iters)
        ag = (model_agreement(params, q, a2, mels, agree_cfg,
                              comp_cfg=dataclasses.replace(agree_cfg, **ckw) if ckw else None)
              if name != "dense" else {"token_agreement": 1.0, "top1_agreement": 1.0,
                                       "mean_kl": 0.0, "logit_rel_err": 0.0})
        s_full = a2.max_source_positions
        cross_s = (s_full - ckw["cross_kv_merge"] if ckw.get("cross_kv_merge")
                   else -(-s_full // ckw.get("cross_kv_pool", 1)))
        entry = {
            "name": name + suffix,
            "rtfx": round(rtfx, 2),
            "size_mb": round(size_in_mb(q), 1),
            "hbm_mb": round(analytic_hbm_mb(
                q, a2, batch, kv_int8=kv_int8,
                cross_kv_bytes=1.0 if cross_kv_int8 else 2.0,
                cache_len=64, cross_s=cross_s), 0),
            "params_m": round(leaf_count(q) / 1e6, 1),
            **{k: round(v, 4) for k, v in ag.items()},
        }
        progress(f"# curve {entry['name']}: rtfx={entry['rtfx']} "
                 f"size={entry['size_mb']}MB agree={entry['token_agreement']}")
        if suffix == "":
            base_entry = entry
            points.append(entry)
        else:
            base_entry["recovered"] = entry


def plot_curve(points: list[dict], path: str) -> None:
    """RTFx-vs-size scatter coloured by agreement (matplotlib, Agg; imported
    here, so that the module needs no matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    points = [p for p in points if "error" not in p]
    xs = [p["size_mb"] for p in points]
    ys = [p["rtfx"] for p in points]
    cs = [p["token_agreement"] for p in points]
    sc = ax.scatter(xs, ys, c=cs, cmap="viridis", vmin=0, vmax=1, s=60, zorder=3)
    for p in points:
        ax.annotate(p["name"], (p["size_mb"], p["rtfx"]), fontsize=7,
                    xytext=(4, 4), textcoords="offset points")
        r = p.get("recovered")
        if r is not None and "error" not in r:
            ax.scatter([r["size_mb"]], [r["rtfx"]], marker="^", s=50,
                       c=[r["token_agreement"]], cmap="viridis", vmin=0, vmax=1,
                       zorder=3)
    ax.set_xlabel("stored size (MB)")
    ax.set_ylabel("RTFx (fixed-token decode)")
    ax.set_title("structured compression ladder: size vs throughput "
                 "(color = token agreement vs dense)")
    fig.colorbar(sc, label="token agreement")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
