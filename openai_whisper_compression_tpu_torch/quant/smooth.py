"""SmoothQuant and AWQ: activation-aware per-channel smoothing, the JAX
package's `quant/smooth.py`.

Both rebalance per-channel range between activations and weights at the
LayerNorm -> linear boundaries by an exact rewrite of the float model: the
LN affine (scale and bias) is divided by a per-channel vector s and the
consumer weights' rows are multiplied by it, so `ln_out @ W` is unchanged
while the rescaled weights and activations quantize with less clipping on
outlier channels.

Sites (every LN -> linear boundary of Whisper):
  - encoder/decoder `attn_ln` -> self-attention {q, k, v}
  - decoder `cross_ln`        -> cross-attention {q}
  - encoder/decoder `mlp_ln`  -> {fc1}

SmoothQuant (arXiv:2211.10438): s_j = amax_x_j^α / amax_w_j^(1-α), fixed α.
AWQ (arXiv:2306.00978): s_j = amax_x_j^α (geomean-normalised), α searched
per site on a grid to minimise the quantized-matmul error on captured rows.

Statistics come from one calibration pass under `utils.capture` (the taps
of `models.whisper.encoder_layer` / `decoder_layer`). The scales are
computed in numpy as the JAX package computes them; the fold runs in f32 on
the weights' device and casts back to each leaf's dtype; AWQ's search
quantizes, dequantizes and multiplies on the weights' device.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..config import WhisperArch
from ..models.params import copy_tree
from ..ops.qtensor import QTensor, dequantize
from ..utils import capture

MAX_ROWS = 256  # activation rows kept a site for AWQ's error search

_TAG_OF = {"attn": "attn_ln_out", "cross": "cross_ln_out", "mlp": "mlp_ln_out"}


def _site_keys(n_enc: int, n_dec: int) -> list[str]:
    keys = []
    for i in range(n_enc):
        keys += [f"encoder.{i}.attn", f"encoder.{i}.mlp"]
    for i in range(n_dec):
        keys += [f"decoder.{i}.attn", f"decoder.{i}.cross", f"decoder.{i}.mlp"]
    return keys


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def collect_ln_stats(params: Any, arch: WhisperArch,
                     run_calibration: Callable[[Any], Any]) -> dict:
    """Run `run_calibration(params)` under capture and gather per-site
    statistics {"<site>": {"amax": (d,) f32, "rows": (R, d) f32}} in numpy.

    The callable must drive full forwards (`models.whisper.forward` /
    `decode_logits`), so the record stream is n_enc x (attn, mlp) +
    n_dec x (attn, cross, mlp) a pass; anything else raises."""
    with capture.capturing() as store, torch.no_grad():
        run_calibration(params)
    recs = [r for r in store if r["tag"] in _TAG_OF.values()]
    keys = _site_keys(len(params["encoder"]["layers"]), len(params["decoder"]["layers"]))
    if not recs or len(recs) % len(keys):
        raise ValueError(
            f"capture stream has {len(recs)} LN records, not a multiple of "
            f"{len(keys)} (= sites/pass); run_calibration must call full "
            "forwards")
    stats: dict[str, dict] = {}
    for p in range(len(recs) // len(keys)):
        for k, r in zip(keys, recs[p * len(keys):(p + 1) * len(keys)]):
            if r["tag"] != _TAG_OF[k.rsplit(".", 1)[1]]:
                raise ValueError(f"record stream out of order at {k}: {r['tag']}")
            amax, rows = _numpy(r["per_unit_max_abs"]), _numpy(r["rows"])
            if k not in stats:
                stats[k] = {"amax": amax, "rows": rows}
            else:
                stats[k]["amax"] = np.maximum(stats[k]["amax"], amax)
                if len(stats[k]["rows"]) < MAX_ROWS:
                    stats[k]["rows"] = np.concatenate(
                        [stats[k]["rows"], rows])[:MAX_ROWS]
    return stats


def _sites(params: Any) -> list[tuple[str, dict, list[dict]]]:
    """(site key, LN parameter dict, [consumer linear dicts]) for every
    foldable boundary, in `_site_keys` order."""
    out = []
    for i, layer in enumerate(params["encoder"]["layers"]):
        out.append((f"encoder.{i}.attn", layer["attn_ln"],
                    [layer["attn"]["q"], layer["attn"]["k"], layer["attn"]["v"]]))
        out.append((f"encoder.{i}.mlp", layer["mlp_ln"], [layer["fc1"]]))
    for i, layer in enumerate(params["decoder"]["layers"]):
        out.append((f"decoder.{i}.attn", layer["attn_ln"],
                    [layer["attn"]["q"], layer["attn"]["k"], layer["attn"]["v"]]))
        out.append((f"decoder.{i}.cross", layer["cross_ln"], [layer["cross"]["q"]]))
        out.append((f"decoder.{i}.mlp", layer["mlp_ln"], [layer["fc1"]]))
    return out


def _smoothable(params: Any) -> Any:
    """A copy whose LN and consumer-linear dicts are fresh (leaves shared),
    so that the fold writes into the copy only."""
    out = copy_tree(params)
    for _, ln, consumers in _sites(out):
        _check_float(consumers)
    return out


def _check_float(consumers: list[dict]) -> None:
    for c in consumers:
        if isinstance(c["w"], QTensor):
            raise ValueError("smooth before quantizing: a consumer weight is "
                             "already a QTensor")


def _apply_scale(ln: dict, consumers: list[dict], s: np.ndarray) -> None:
    """Fold in place (into a copied tree): LN affine / s, consumer weight
    rows * s, in f32, each cast back to its dtype. (x / s) @ (s W) = x @ W."""
    sj = torch.from_numpy(np.asarray(s, np.float32)).to(ln["g"].device)
    ln["g"] = (ln["g"].to(torch.float32) / sj).to(ln["g"].dtype)
    if ln.get("b") is not None:
        ln["b"] = (ln["b"].to(torch.float32) / sj).to(ln["b"].dtype)
    for c in consumers:
        w = c["w"]
        c["w"] = (w.to(torch.float32) * sj[:, None]).to(w.dtype)


def _safe_scale(s: np.ndarray) -> np.ndarray:
    s = np.where(np.isfinite(s) & (s > 0), s, 1.0)
    return np.clip(s, 1e-4, 1e4).astype(np.float32)


def smoothquant_params(params: Any, arch: WhisperArch,
                       run_calibration: Callable[[Any], Any] | None = None,
                       stats: dict | None = None, alpha: float = 0.5) -> Any:
    """SmoothQuant: a float tree equivalent to `params` with
    s_j = amax_x_j^alpha / amax_w_j^(1-alpha) folded at every LN -> linear
    boundary. Quantize the result with any REGISTRY method."""
    if stats is None:
        if run_calibration is None:
            raise ValueError("need run_calibration or precollected stats")
        stats = collect_ln_stats(params, arch, run_calibration)
    out = _smoothable(params)
    for key, ln, consumers in _sites(out):
        ax = stats[key]["amax"]
        aw = _numpy(torch.cat([c["w"].to(torch.float32) for c in consumers],
                              dim=1).abs().amax(dim=1))
        s = _safe_scale(ax ** alpha / np.maximum(aw, 1e-8) ** (1.0 - alpha))
        _apply_scale(ln, consumers, s)
    return out


def _resolve_quantizer(method: str, **kw):
    """method -> weight-quantizer callable. Takes QUANTIZERS names and
    REGISTRY names (their base method and kwargs); fails before any
    calibration, naming the valid namespaces."""
    from .api import REGISTRY
    from .core import QUANTIZERS

    if method in QUANTIZERS:
        return lambda w: QUANTIZERS[method](w, **kw)
    cfg = REGISTRY.get(method)
    if cfg is not None and cfg.method in QUANTIZERS:
        merged = {**dict(cfg.kwargs), **kw}
        return lambda w: QUANTIZERS[cfg.method](w, **merged)
    raise KeyError(f"unknown quant method {method!r}; quantizers: "
                   f"{sorted(QUANTIZERS)}; named configs: {sorted(REGISTRY)}")


def _site_quant_error(x: torch.Tensor, ws: list[torch.Tensor],
                      exacts: list[torch.Tensor], s: np.ndarray, quantizer) -> float:
    """Mean squared error of the smoothed-then-quantized matmuls against the
    exact ones, summed over the site's consumers, on the captured rows x.
    The exact products do not depend on alpha: computed once a site."""
    sj = torch.from_numpy(s).to(x.device)
    xs = x / sj[None, :]
    err = 0.0
    for wj, exact in zip(ws, exacts):
        wq = dequantize(quantizer(wj * sj[:, None]), torch.float32)
        err += float(torch.mean((xs @ wq - exact) ** 2))
    return err


def awq_search(params: Any, arch: WhisperArch,
               run_calibration: Callable[[Any], Any] | None = None,
               stats: dict | None = None, method: str = "int4", grid: int = 11,
               **quant_kw) -> tuple[Any, dict[str, float]]:
    """AWQ: per site, alpha on a grid over [0, 1] (s_j = amax_x_j^alpha,
    geomean-normalised) minimising the quantized-matmul error on the
    captured rows; the first alpha of the least error wins. Returns
    (smoothed float params, {site: alpha}). alpha = 0 is no smoothing, so
    AWQ never does worse than plain quantization on the calibration rows."""
    quantizer = _resolve_quantizer(method, **quant_kw)   # fail fast
    if stats is None:
        if run_calibration is None:
            raise ValueError("need run_calibration or precollected stats")
        stats = collect_ln_stats(params, arch, run_calibration)
    out = _smoothable(params)
    alphas: dict[str, float] = {}
    with torch.no_grad():
        for key, ln, consumers in _sites(out):
            ax = np.maximum(stats[key]["amax"], 1e-8)
            ws = [c["w"].to(torch.float32) for c in consumers]
            x = torch.from_numpy(np.asarray(stats[key]["rows"], np.float32)).to(ws[0].device)
            exacts = [x @ w for w in ws]
            best_alpha, best_s, best_err = 0.0, np.ones_like(ax), np.inf
            for alpha in np.linspace(0.0, 1.0, grid):
                s = ax ** alpha
                s = _safe_scale(s / np.exp(np.mean(np.log(np.maximum(s, 1e-8)))))
                err = _site_quant_error(x, ws, exacts, s, quantizer)
                if err < best_err:
                    best_alpha, best_s, best_err = float(alpha), s, err
            _apply_scale(ln, consumers, best_s)
            alphas[key] = best_alpha
    return out, alphas


def awq_quantize_params(params: Any, arch: WhisperArch,
                        run_calibration: Callable[[Any], Any],
                        method: str = "int4", grid: int = 11, **quant_kw) -> Any:
    """AWQ-smooth, then quantize every linear with `method`."""
    from .api import quantize_params

    smoothed, _ = awq_search(params, arch, run_calibration, method=method,
                             grid=grid, **quant_kw)
    return quantize_params(smoothed, method, **quant_kw)
