"""Recovery distillation: fine-tune a compressed student against its own
uncompressed teacher, the JAX package's `distill.py`.

Pipeline: prune (keeping the zeros) -> `distill(student, teacher, ...)` ->
re-evaluate. The KL loss needs no labels: the teacher's logits are the
targets, over synthetic 30 s waveforms pushed through the mel frontend (or
the batches of `batch_fn`). Sparsity is kept exactly: gradients and
parameters are projected onto the pruned support each step.

A step: the teacher's logits from a forward under `torch.no_grad()` (the
kernels may serve it), the student's KL loss and its gradient by autograd
over the plain paths (no kernel has a backward), the mask projection of the
gradients, one `torch.optim.AdamW` step with optax.adamw's defaults
(betas (0.9, 0.999), eps 1e-8, weight decay 1e-4: torch's default decay
is 1e-2), and the mask projection of the parameters. optax's update
-lr·(m̂/(√v̂ + eps) + wd·p) is torch's decoupled step.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .audio import features
from .config import WhisperArch
from .evaluation.harness import samples_for_arch
from .models.params import copy_tree, named_leaves, set_leaf
from .models.whisper import decode_logits, encode
from .ops.qtensor import QTensor

Params = dict[str, Any]

ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}  # optax.adamw's


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def sparsity_masks(params: Params) -> Any:
    """Zero-pattern masks (x != 0) of every dense weight of two or more
    dims, None elsewhere: the pruned support distillation keeps."""
    def mask(x):
        if isinstance(x, QTensor) or not isinstance(x, torch.Tensor) or x.dim() < 2:
            return None
        return x != 0
    return _map(mask, params)


def kl_loss(student: Params, teacher_logits: torch.Tensor, arch: WhisperArch,
            mel: torch.Tensor, tokens: torch.Tensor,
            temperature: float = 2.0) -> torch.Tensor:
    """Mean KL(teacher || student) over all positions at `temperature`,
    times temperature²."""
    return _kl(decode_logits(student, arch, tokens, encode(student, arch, mel)),
               teacher_logits, temperature)


def _kl(s_logits: torch.Tensor, teacher_logits: torch.Tensor,
        t: float) -> torch.Tensor:
    p = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    q = torch.log_softmax(s_logits.float() / t, dim=-1)
    return torch.mean(torch.sum(torch.exp(p) * (p - q), dim=-1)) * (t * t)


def _gathered(tree: Params, mesh) -> Params:
    """The whole tree from this rank's shard, differentiably (each split
    leaf all-gathered, its gradient reduce-scattered back): the input of a
    `param_transform` that must see whole weights (a per-column quantizer
    over a row-split weight)."""
    from .parallel import mesh as mesh_lib
    from .parallel.tp_forward import gather_leaf

    def gather(x, spec):
        if x is None:
            return None
        for dim, ax in enumerate(spec):
            if ax is not None and dim < x.dim():
                x = gather_leaf(x, mesh, ax, dim)
        return x

    return mesh_lib._map2(gather, tree, mesh_lib.param_specs(tree))


def _synthetic_batch(rng: np.random.Generator, arch: WhisperArch, batch: int,
                     seq_len: int, n_samples: int, device) -> tuple:
    """The JAX package's draws: 0.1-scaled white noise through the mel
    frontend, <|sot|> then uniform random tokens."""
    wav = torch.from_numpy(
        (rng.standard_normal((batch, n_samples)) * 0.1).astype(np.float32)).to(device)
    mel = features.preprocess(wav, n_mels=arch.num_mel_bins, length=n_samples)
    tokens = np.concatenate([np.full((batch, 1), arch.decoder_start_token_id),
                             rng.integers(0, arch.vocab_size, (batch, seq_len - 1))],
                            axis=1)
    return mel, torch.from_numpy(tokens.astype(np.int64)).to(device)


def distill(student: Params, teacher: Params, arch: WhisperArch,
            steps: int = 50, lr: float = 3e-5, batch: int = 2,
            seq_len: int = 8, temperature: float = 2.0, seed: int = 0,
            preserve_sparsity: bool = True,
            sparsity_ref: Params | None = None,
            batch_fn: Callable[[np.random.Generator], tuple] | None = None,
            param_transform: Callable[[Params], Params] | None = None,
            mesh=None, compute_dtype=None) -> tuple[Params, list[float]]:
    """KL-distill `student` toward `teacher` (same arch) on the tree's device.

    batch_fn: optional (rng) -> (mel (B, M, F), tokens (B, L)[, teacher
    logits (B, L, V)]) supplier in place of the synthetic noise; a third
    element skips the teacher's forward.
    sparsity_ref: take the frozen-zero masks from this tree instead of
    `student` (the pruned model before a quantization round trip, so that
    only the pruned zeros are frozen, not every weight rounded to zero).
    param_transform: a function applied to the student inside the loss
    (QAT's straight-through fake quantization, `quant.qat`); the gradient
    flows through it to the latent student.
    compute_dtype: the dtype the optimisation runs in (floating leaves cast
    at entry, back at exit), e.g. torch.float32 for a bf16 model, whose
    AdamW steps at lr ~1e-4 sit below bf16's resolution.
    mesh: a `parallel.mesh.Mesh` (('dp', 'tp') axes, every rank calling
    with the same arguments): student, teacher and masks are placed with
    `shard_params`, each batch is split over 'dp' (`batch` must divide by
    it), both forwards are tensor-parallel (`tp_forward.forward_local`), a
    `param_transform` sees the whole (gathered) weights, the gradients and
    the reported loss are averaged over 'dp', and every rank returns the
    whole recovered tree.

    Returns (recovered student, per-step loss history). Quantized leaves
    are refused: dequantize first."""
    if any(isinstance(leaf, QTensor) for _, leaf in named_leaves(student)):
        raise ValueError("student has quantized leaves; distill the dense "
                         "(or dequantized fake-quant) model, then requantize")
    rows = None
    if mesh is not None:
        from .parallel import mesh as mesh_lib
        from .parallel.tp_forward import forward_local

        student = mesh_lib.shard_params(student, mesh)
        teacher = None if teacher is None else mesh_lib.shard_params(teacher, mesh)
        if sparsity_ref is not None:
            sparsity_ref = mesh_lib.shard_params(sparsity_ref, mesh)
        rows = mesh_lib.batch_sharding(mesh)
        dp = mesh.shape.get("dp", 1)

        def logits_fn(p, mel, tokens):
            return forward_local(p, arch, mel, tokens, mesh)
    else:
        def logits_fn(p, mel, tokens):
            return decode_logits(p, arch, tokens, encode(p, arch, mel))
    leaves = named_leaves(student)
    device = student["encoder"]["ln"]["g"].device
    n_samples = samples_for_arch(arch)
    floating = [(n, t) for n, t in leaves
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
    orig_dtypes = {n: t.dtype for n, t in floating}
    latent = {n: t.detach().to(compute_dtype or t.dtype).clone().requires_grad_(True)
              for n, t in floating}
    tree = copy_tree(student)
    for n, t in latent.items():
        set_leaf(tree, n, t)
    masks = {}
    if preserve_sparsity:
        masks = {n: m for n, m in named_leaves(sparsity_masks(
            student if sparsity_ref is None else sparsity_ref))
            if m is not None and n in latent}
    opt = torch.optim.AdamW(list(latent.values()), lr=lr, **ADAMW)

    rng = np.random.default_rng(seed)
    history: list[float] = []
    for _ in range(steps):
        t_logits = None
        if batch_fn is not None:
            mel, tokens, *rest = batch_fn(rng)
            if rest:              # the caller's precomputed teacher logits
                t_logits = torch.as_tensor(rest[0], device=device)
            mel = torch.as_tensor(mel, device=device)
            tokens = torch.as_tensor(tokens, device=device).long()
        else:
            mel, tokens = _synthetic_batch(rng, arch, batch, seq_len, n_samples, device)
        if rows is not None:
            mel, tokens = rows(mel), rows(tokens)
            t_logits = None if t_logits is None else rows(t_logits)
        if t_logits is None:
            with torch.no_grad():
                t_logits = logits_fn(teacher, mel, tokens)
        if param_transform is None:
            s = tree
        elif mesh is None:
            s = param_transform(tree)
        else:
            s = mesh_lib.shard_params(param_transform(_gathered(tree, mesh)), mesh)
        loss = _kl(logits_fn(s, mel, tokens), t_logits.detach(), temperature)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        with torch.no_grad():
            if mesh is not None and dp > 1:
                for t in latent.values():
                    t.grad.copy_(mesh_lib.all_reduce(t.grad, mesh, "dp") / dp)
                loss = mesh_lib.all_reduce(loss.detach(), mesh, "dp") / dp
            for n, m in masks.items():
                latent[n].grad.masked_fill_(~m, 0)
            opt.step()
            for n, m in masks.items():
                latent[n].masked_fill_(~m, 0)
        history.append(float(loss.detach()))
    out = copy_tree(student)
    for n, t in latent.items():
        set_leaf(out, n, t.detach().to(orig_dtypes[n]))
    if mesh is not None:
        out = mesh_lib.unshard_params(out, mesh)
    return out, history


def fake_quant_recovery(params_q: Params, teacher: Params, arch: WhisperArch,
                        method: str = "int4", steps: int = 50, lr: float = 3e-5,
                        **distill_kw) -> Params:
    """Dequantize a quantized model (its rounding error baked into dense
    weights), KL-distill it toward the dense teacher, requantize with the
    same method. For fake-quant forwards every step (straight-through
    gradients), use `quant.qat.qat_distill`. Returns the requantized model."""
    from .quant.api import dequantize_params, quantize_params

    recovered, _ = distill(dequantize_params(params_q), teacher, arch, steps=steps,
                           lr=lr, preserve_sparsity=False, **distill_kw)
    return quantize_params(recovered, method=method)
