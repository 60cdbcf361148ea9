"""GPTQ: Hessian-aware one-shot weight quantization (arXiv:2210.17323), the
JAX package's `quant/gptq.py`.

Per layer it minimises ||X (W - Ŵ)||² over the calibration activations X:
input dims are quantized in order and each dim's rounding error is carried
through the upper Cholesky factor of H^-1 onto the dims not yet quantized.

- Hessians: one forward over the calibration batch with the `ops.linear`
  tap set; the tap keys weights by identity and adds X^T X for each in f32
  on the activations' device (the caller keeps TF32 off for full-f32 sums).
- The solve (`gptq_solve`) is a loop over the K input dims in plain torch
  on the weight's device, the JAX package's jitted `fori_loop` (no Pallas
  kernel there): per dim a round, a clip, an error and a rank-1 update of
  the rows still to come, each fused multiply-add of XLA's loop rounded
  once as XLA's is. It reads nothing back inside the loop; the
  Cholesky's finiteness is one host read a damping attempt.
  `torch.linalg.inv` / `cholesky` stand in for `jnp.linalg`.
- Output: the standard per-channel QTensors (int8_pc, int4_pack, int2_pack),
  which the int8 / int4 matmul kernels serve as they serve RTN weights.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.params import copy_tree, named_leaves, set_leaf
from ..ops import linear as linear_mod
from ..ops.qtensor import QTensor, inv_f32, pack_int_sub8
from .api import LINEAR_WEIGHT_RE


class _HessianTap:
    """Adds X^T X per tapped weight (keyed by the tensor's identity), as f32
    tensors on the activations' device."""

    def __init__(self, targets: dict[int, str]):
        self.targets = targets          # id(weight) -> dotted name
        self.hessians: dict[str, torch.Tensor] = {}

    def observe(self, w, x: torch.Tensor) -> None:
        name = self.targets.get(id(w))
        if name is None:
            return
        with torch.no_grad():
            x2 = x.detach().reshape(-1, x.shape[-1]).to(torch.float32)
            h = x2.t() @ x2
            if name in self.hessians:
                self.hessians[name] += h
            else:
                self.hessians[name] = h


def collect_hessians(params: Any, run_calibration: Callable[[Any], Any],
                     name_filter: Callable[[str], bool] | None = None
                     ) -> dict[str, torch.Tensor]:
    """Run `run_calibration(params)` and return {weight name: X^T X} for
    every 2-D linear weight it touched."""
    targets: dict[int, str] = {}
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor) or not isinstance(leaf, torch.Tensor):
            continue
        if leaf.dim() != 2 or not LINEAR_WEIGHT_RE.search(name):
            continue
        if name_filter is not None and not name_filter(name):
            continue
        targets[id(leaf)] = name
    tap = _HessianTap(targets)
    prev = linear_mod._TAP
    linear_mod._TAP = tap
    try:
        with torch.no_grad():
            run_calibration(params)
    finally:
        linear_mod._TAP = prev
    return tap.hessians


def _factor(hessian: torch.Tensor, damp: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(U, ok): the upper Cholesky factor of the damped Hessian's inverse,
    f32 on the Hessian's device, and whether it is finite. Dead input dims
    (a diagonal <= 0) are pinned to the mean diagonal after the damping, so
    that the solve is well-posed. The inverse carries cond(H) x 2^-24 of
    error, which LAPACK on the CPU, cuSOLVER on the card and XLA leave
    differently (1e-3 relative at a calibration's Hessians)."""
    h = hessian.to(torch.float32)
    k = h.shape[0]
    diag = torch.diagonal(h)
    mean_diag = torch.clamp(diag.mean(), min=1e-8)
    h = h + torch.eye(k, dtype=torch.float32, device=h.device) * (damp * mean_diag)
    dead = torch.diag_embed((diag <= 0).to(torch.float32)).bool()
    h = torch.where(dead, mean_diag, h)
    hinv, inv_info = torch.linalg.inv_ex(h)
    hinv = (hinv + hinv.t()) * 0.5   # symmetric before the Cholesky
    # Hinv = L L^T -> U = L^T (upper), Hinv = U^T U. An ill-conditioned H can
    # make the inverse non-PD: where either factorisation fails, U is NaN,
    # as JAX's linalg returns NaN silently (the `_ex` forms never raise)
    l, chol_info = torch.linalg.cholesky_ex(hinv)
    u = torch.where((inv_info == 0) & (chol_info == 0), l.t(),
                    torch.full_like(l, float("nan")))
    return u, torch.isfinite(u).all()


def _quantize_rows(w: torch.Tensor, scale: torch.Tensor, u: torch.Tensor,
                   qmax: int) -> torch.Tensor:
    """The codes of w (K, N) f32 row by row, each row's rounding error
    carried onto the rows after it through U (rows <= i are never read
    again, so the codes are those of the JAX loop, which updates every row).
    XLA contracts w_i - q_i·s and the rank-1 update into fused
    multiply-adds: each is computed here in f64 (where the product of two
    f32 values is exact) and rounded to f32 once, as an FMA rounds. Plain
    IEEE arithmetic, so the CPU and the card give the same codes for the
    same U."""
    k = w.shape[0]
    wc = w.clone()
    q = torch.empty_like(w)
    s64, u64 = scale[0].double(), u.double()
    for i in range(k):
        w_i = wc[i]
        qi = torch.clamp(torch.round(w_i / scale[0]), -qmax, qmax)
        q[i] = qi
        err = (w_i.double() - qi.double() * s64).float() / u[i, i]
        if i + 1 < k:
            wc[i + 1:] = (wc[i + 1:].double()
                          - u64[i, i + 1:, None] * err.double()[None, :]).float()
    return q.to(torch.int8)


def gptq_solve(w: torch.Tensor, hessian: torch.Tensor, bits: int = 4,
               damp: float = 0.01) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPTQ solve of one (K, N) weight against its (K, K) Hessian, on w's
    device. Returns (q (K, N) int8 codes in [-qmax, qmax], scale (1, N) f32,
    ok 0-dim bool on the device: False where the Cholesky went non-finite).
    Per-output-channel symmetric scales are fixed from W first, max|w| times
    f32(1 / qmax) as XLA compiles the jitted JAX division by a constant."""
    w = w.to(torch.float32)
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(w.abs().amax(dim=0, keepdim=True) * inv_f32(qmax), min=1e-12)
    u, ok = _factor(hessian.to(w.device), damp)
    return _quantize_rows(w, scale, u, qmax), scale, ok


def _rtn(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Round to nearest at the per-channel scales, as the JAX package's
    eager fallback: max|w| / qmax there is a true division (no jit)."""
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=0, keepdim=True) / qmax, min=1e-12)
    return torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8), scale


def quantize_gptq(w: torch.Tensor, hessian: torch.Tensor, bits: int = 4,
                  damp: float = 0.01) -> QTensor:
    """GPTQ-quantize one weight into int8_pc (8 bits) or packed int4 / int2.
    Where the inverse-Hessian Cholesky went non-finite, retry at 10x and
    100x the damping; then fall back to round-to-nearest at the
    per-channel scales: never NaN-derived weights."""
    for d in (damp, damp * 10, damp * 100):
        q, scale, ok = gptq_solve(w, hessian, bits=bits, damp=d)
        if bool(ok):
            break
    else:
        q, scale = _rtn(w, bits)
    shape = tuple(w.shape)
    if bits == 8:
        return QTensor(data=q, scale=scale, kind="int8_pc", bits=8, shape=shape)
    return QTensor(data=pack_int_sub8(q.to(torch.int32), bits), scale=scale,
                   kind="int4_pack" if bits == 4 else "int2_pack", bits=bits,
                   shape=shape)


def gptq_quantize_params(params: Any, run_calibration: Callable[[Any], Any],
                         bits: int = 4, damp: float = 0.01,
                         name_filter: Callable[[str], bool] | None = None) -> Any:
    """Whole-model GPTQ: Hessians from one calibration pass, then a solve of
    every linear weight it touched. Weights the calibration never ran stay
    dense (they have no Hessian)."""
    hessians = collect_hessians(params, run_calibration, name_filter=name_filter)
    out = copy_tree(params)
    for name, leaf in named_leaves(params):
        h = hessians.get(name)
        if h is not None:
            set_leaf(out, name, quantize_gptq(leaf, h, bits=bits, damp=damp))
    return out
