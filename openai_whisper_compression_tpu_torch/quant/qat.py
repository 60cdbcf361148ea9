"""Quantization-aware training by straight-through estimators, the JAX
package's `quant/qat.py`.

Every training forward runs on fake-quantized weights, so the loss the
optimizer sees is the loss of the deployed quantized model, while the
gradient passes straight through to the latent dense weights. The
transform reuses the `QUANTIZERS` that deployment uses, so the final
`quantize_params(latent)` computes exactly the weights the last step
optimised. With `distill`'s mask projection and the symmetric quantizers
mapping 0 to 0, sparse + QAT gives a model both sparse and quantized.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.params import copy_tree, get_leaf, named_leaves, set_leaf
from ..ops.qtensor import QTensor, dequantize
from .api import EMBED_RE, LINEAR_WEIGHT_RE, quantize_params
from .core import QUANTIZERS

Params = dict[str, Any]


def resolve_method(method: str, kw: dict[str, Any]) -> tuple[str, dict[str, Any]]:
    """method -> (QUANTIZERS name, merged kwargs), for QUANTIZERS names and
    REGISTRY names (a config's dtype and activation mode are ignored: QAT
    models the weight rounding only). Raises at once on an unknown name."""
    if method in QUANTIZERS:
        return method, dict(kw)
    from .api import REGISTRY

    cfg = REGISTRY.get(method)
    if cfg is not None and cfg.method in QUANTIZERS:
        return cfg.method, {**dict(cfg.kwargs), **kw}
    raise KeyError(
        f"unknown or non-weight-quant method {method!r} for QAT; "
        f"quantizers: {sorted(QUANTIZERS)}; resolvable configs: "
        f"{sorted(n for n, c in REGISTRY.items() if c.method in QUANTIZERS)}")


def ste_fake_quant(w: torch.Tensor, method: str = "int8", **kw: Any) -> torch.Tensor:
    """dequantize(QUANTIZERS[method](w)) in w's dtype, with the identity as
    its gradient: `fq.detach() + (w - w.detach())`, whose forward is fq bit
    for bit (w - w is an exact zero), not `w + (fq - w).detach()`, which
    differs from fq by a rounding."""
    method, kw = resolve_method(method, kw)
    fq = dequantize(QUANTIZERS[method](w.detach(), **kw), torch.float32).to(w.dtype)
    return fq.detach() + (w - w.detach())


def quantized_leaf_names(params: Params, include_embed: bool = False,
                         name_filter: Callable[[str], bool] | None = None) -> list[str]:
    """The dotted names `quantize_params` would quantize, fixed once."""
    names = []
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor):
            continue
        if not (LINEAR_WEIGHT_RE.search(name) or (include_embed and EMBED_RE.match(name))):
            continue
        if name_filter is not None and not name_filter(name):
            continue
        names.append(name)
    return names


def make_ste_transform(params: Params, method: str = "int8",
                       include_embed: bool = False,
                       name_filter: Callable[[str], bool] | None = None,
                       **kw: Any) -> Callable[[Params], Params]:
    """The fake-quant transform for `distill(param_transform=)`: the leaves
    `quantize_params` would quantize (chosen from `params` once) replaced by
    `ste_fake_quant` of themselves."""
    method, kw = resolve_method(method, kw)   # fail fast, before any step
    names = quantized_leaf_names(params, include_embed, name_filter)

    def transform(p: Params) -> Params:
        out = copy_tree(p)
        for name in names:
            set_leaf(out, name, ste_fake_quant(get_leaf(p, name), method, **kw))
        return out

    return transform


def qat_distill(student: Params, teacher: Params, arch: Any, method: str = "int4",
                steps: int = 60, lr: float = 3e-5, include_embed: bool = False,
                name_filter: Callable[[str], bool] | None = None,
                quant_kwargs: dict[str, Any] | None = None,
                **distill_kw: Any) -> tuple[Params, list[float]]:
    """QAT: KL-distill the dense `student` toward `teacher` with every
    forward on straight-through fake-quantized weights, then quantize the
    latent weights with the same quantizer. Returns (quantized params,
    per-step loss history)."""
    from ..distill import distill

    method, qkw = resolve_method(method, dict(quant_kwargs or {}))
    transform = make_ste_transform(student, method, include_embed, name_filter, **qkw)
    latent, history = distill(student, teacher, arch, steps=steps, lr=lr,
                              param_transform=transform, **distill_kw)
    out = quantize_params(latent, method, include_embed=include_embed,
                          name_filter=name_filter, **qkw)
    return out, history


# every QUANTIZERS entry is plain tensor arithmetic, so each can be trained
QAT_METHODS = tuple(sorted(QUANTIZERS))
