"""Experiment config matrices: one registry in place of the reference's
per-script dicts.

The port of the JAX package's `sweep/configs.py`: the same config names in
the same order, over the port's `quant.api` and `prune.*`. Sources: the
quantization matrix (`quantization.py:42-90`), the unstructured pruning
ladder (`unstructured_L1_baseline.py:1143`), the experimental pruning matrix
(`experimental_pruning.py:2378-2704`), the combined prune + quant matrix
(`pruning+quantization/pruning_quantization_all.py:1392-1460`).

Each entry: {"name", "apply": (params, arch) -> params', "needs_calibration"?}
(data-aware entries: {"name", "apply": (params, arch, run_cal) -> params',
"needs_data": True}). Compression composes by function composition.
"""

from __future__ import annotations

from typing import Any, Callable

from ..quant import api as quant_api
from ..prune import magnitude, recipe, structured, targeted

Transform = Callable[[Any, Any], Any]  # (params, arch) -> params'


def _q(name: str) -> Transform:
    return lambda p, a: quant_api.apply_named_config(p, name)


def quant_sweep() -> list[dict]:
    """The 13-config quantization matrix (`quantization.py:42-90`) plus the
    bnb dynamic variants (`evaluation_dynamic.py:177-247`)."""
    names = ["baseline_fp32", "baseline_bf16", "fp16", "pytorch_dynamic_int8",
             "quanto_int2", "quanto_int4", "quanto_int8",
             "hqq_int3", "hqq_int4", "hqq_int8",
             "static_int8_act_int8", "static_int4_act_int8",
             "static_int8_act_fp8", "static_int4_act_fp8",
             "static_fp8_act_int8", "static_fp8_act_fp8", "static_fp8",
             "bnb_fp4", "bnb_fp4_double_quant", "bnb_nf4",
             "bnb_nf4_double_quant", "bnb_nf4_bf16_compute"]
    return [{"name": n, "apply": _q(n),
             "needs_calibration": quant_api.REGISTRY[n].needs_calibration}
            for n in names]


def unstructured_l1_sweep(
        amounts=(0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99),
) -> list[dict]:
    """Global L1 ladder (`unstructured_L1_baseline.py:1143`)."""
    return [{"name": f"l1_global_{int(a * 100)}pct",
             "apply": (lambda a_: lambda p, arch: magnitude.prune_global_l1(p, a_))(a)}
            for a in amounts]


def random_pruning_sweep(amounts=(0.1, 0.3, 0.5, 0.7, 0.9)) -> list[dict]:
    return [{"name": f"random_{int(a * 100)}pct",
             "apply": (lambda a_: lambda p, arch: magnitude.prune_random(p, a_))(a)}
            for a in amounts]


def _progressive_layerwise(p, arch):
    """10% early / 20% mid / 40% late layers, encoder and decoder
    (`experimental_pruning.py:2487-2493` progressive_layerwise)."""
    for comp, n_layers in (("encoder", arch.encoder_layers),
                           ("decoder", arch.decoder_layers)):
        lo, hi = n_layers // 3, 2 * n_layers // 3
        for amount, sel in ((0.1, range(0, lo)), (0.2, range(lo, hi)),
                            (0.4, range(hi, n_layers))):
            if sel:
                p = magnitude.prune_per_module_l1(
                    p, amount, name_filter=targeted.layers_of(comp, set(sel)))
    return p


def _attention_vs_ffn(p, arch, attn_amount=0.1, ffn_amount=0.4):
    """Lighter attention / heavier FFN ratio (`experimental_pruning.py:506`,
    attention_vs_ffn config :2513-2520)."""
    attn = targeted.union(targeted.self_attn_encoder,
                          targeted.self_attn_decoder,
                          targeted.cross_attn_decoder)
    p = magnitude.prune_per_module_l1(p, attn_amount, name_filter=attn)
    return magnitude.prune_per_module_l1(
        p, ffn_amount,
        name_filter=targeted.union(targeted.ffn_encoder, targeted.ffn_decoder))


def _multi_level(p, arch, head_amount=0.4, mlp_amount=0.4):
    """Heads in encoder + MLP weights in decoder
    (`custom_multi_level_pruning`, `experimental_pruning.py:1187-1333`)."""
    p = structured.prune_heads_by_l1(p, arch, head_amount,
                                     components=("encoder.attn",),
                                     physical=False)
    return magnitude.prune_per_module_l1(p, mlp_amount,
                                         name_filter=targeted.ffn_decoder)


def _mixed_strategy(p, arch, head_amount=0.3, weight_amount=0.2):
    """Head pruning then unstructured L1 on the non-attention linears
    (`custom_mixed`, `experimental_pruning.py:2695-2702`, main :3091-3120)."""
    p = structured.prune_heads_by_l1(p, arch, head_amount, physical=False)
    return magnitude.prune_per_module_l1(
        p, weight_amount,
        name_filter=targeted.union(targeted.ffn_encoder, targeted.ffn_decoder))


def experimental_pruning_sweep(arch) -> list[dict]:
    """The experimental matrix (`experimental_pruning.py:2378-2704`):
    targeted components, layer sections, progressive/multi-level/mixed
    strategies, structured variants, head/layer-level surgery. 35 configs
    (reference ~35; the two gradient/activation-guided entries live in the
    `sensitivity` CLI instead — they need calibration batches)."""
    E, D = arch.encoder_layers, arch.decoder_layers
    cfgs: list[dict] = []

    def add(name, fn):
        cfgs.append({"name": name, "apply": fn})

    for a in (0.3, 0.4):
        pct = int(a * 100)
        add(f"encoder_only_{pct}", lambda p, arch, a=a: magnitude.prune_per_module_l1(
            p, a, name_filter=targeted.encoder_only))
        add(f"decoder_only_{pct}", lambda p, arch, a=a: magnitude.prune_per_module_l1(
            p, a, name_filter=targeted.decoder_only))
    add("self_attn_encoder_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.self_attn_encoder))
    add("self_attn_decoder_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.self_attn_decoder))
    add("cross_attn_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.cross_attn_decoder))
    add("ffn_encoder_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.ffn_encoder))
    add("ffn_decoder_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.ffn_decoder))
    add("conv_30", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.3, name_filter=targeted.conv_layers))
    add("token_emb_25", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.25, name_filter=targeted.token_embeddings))
    add("bias_50", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.5, name_filter=targeted.bias_only))
    add("layernorm_30", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.3, name_filter=targeted.layernorm_only))
    add("proj_out_25", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.25, name_filter=targeted.proj_out))
    add("enc_early_l1_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.layer_section("encoder", "early", E, 2)))
    add("enc_late_l1_40", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.4, name_filter=targeted.layer_section("encoder", "late", E, 2)))
    add("dec_first_layer_50", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.5, name_filter=targeted.first_last_layer("decoder", "first", D)))
    add("l2_structured_30", lambda p, arch: structured.prune_l2_structured(p, 0.3))
    add("block4x4_50", lambda p, arch: magnitude.prune_blocks(p, 0.5))
    add("heads_l1_25_masked", lambda p, arch: structured.prune_heads_by_l1(
        p, arch, 0.25, physical=False))
    add("heads_l1_25_physical", lambda p, arch: structured.prune_heads_by_l1(
        p, arch, 0.25, physical=True))
    add("drop_dec_last_layer", lambda p, arch: structured.drop_layers(
        p, "decoder", [D - 1]))
    add("remove_enc_mlp_last", lambda p, arch: structured.remove_mlp(
        p, "encoder", [E - 1]))
    add("combined_encoder_decoder_30", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.3, name_filter=magnitude.linear_weights))
    add("attention_only_20", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.2, name_filter=targeted.union(
            targeted.self_attn_encoder, targeted.self_attn_decoder,
            targeted.cross_attn_decoder)))
    add("qkv_projections_30", lambda p, arch: magnitude.prune_per_module_l1(
        p, 0.3, name_filter=targeted.qkv_projections_only))
    add("attention_vs_ffn", _attention_vs_ffn)
    add("progressive_layerwise", _progressive_layerwise)
    add("pos_embedding_position_dependent",
        lambda p, arch: magnitude.prune_positional_position_dependent(p))
    add("pos_embedding_progressive",
        lambda p, arch: magnitude.prune_positional_progressive(p))
    add("multi_level_enc_heads_dec_mlp", _multi_level)
    add("mixed_head30_weight20", _mixed_strategy)
    add("head_pruning_40", lambda p, arch: structured.prune_heads_by_l1(
        p, arch, 0.4, physical=False))
    add("thesis_recipe", lambda p, arch: recipe.apply_recipe(p, arch))
    add("thesis_recipe_increased", lambda p, arch: recipe.apply_recipe(
        p, arch, recipe.INCREASED_RECIPE))
    return cfgs


def prune_quant_sweep(quant_names: tuple[str, ...] = (
        "pytorch_dynamic_int8", "quanto_int4", "quanto_int8", "hqq_int3",
        "hqq_int4", "hqq_int8", "bnb_fp4", "bnb_nf4",
        "bnb_nf4_double_quant", "static_int8_act_int8",
        "static_int4_act_int8", "static_int8_act_fp8", "static_int4_act_fp8",
        "static_fp8_act_int8", "static_fp8_act_fp8", "static_fp8",
        "fp16", "baseline_bf16",
)) -> list[dict]:
    """Prune once with the thesis recipe, then each quant config on the
    pruned model — full 6-combo static matrix included
    (`pruning_quantization_all.py:1392-1460`: baseline + quanto x2 +
    pytorch + hqq x3 + bnb x2 + static x6 = 15; here 18 with the
    double-quant/fp16/bf16 extras)."""
    def combo(qname):
        def f(p, arch):
            pruned = recipe.apply_recipe(p, arch)
            return quant_api.apply_named_config(pruned, qname)
        return f

    return [{"name": f"pruned+{q}", "apply": combo(q),
             "needs_calibration": quant_api.REGISTRY[q].needs_calibration}
            for q in quant_names]


def data_aware_sweep() -> list[dict]:
    """Data-aware PTQ matrix (GPTQ / SmoothQuant / AWQ — beyond-reference,
    `quant_api.DATA_AWARE`). Each config's `apply` takes
    (params, arch, run_calibration); the driver builds the eager
    calibration callable from the calibration split."""
    def mk(name):
        return {"name": name,
                "apply": (lambda p, a, run_cal, n=name:
                          quant_api.quantize_data_aware(p, a, n, run_cal)),
                "needs_data": True}

    return ([{"name": "baseline_fp32", "apply": _q("baseline_fp32")}]
            + [mk(n) for n in sorted(quant_api.DATA_AWARE)])


def mixed_precision_sweep(
        budgets: tuple[float, ...] = (4.0, 4.5, 5.0, 6.0, 7.0),
        ladder: tuple[str, ...] = ("int4", "int8")) -> list[dict]:
    """Average-bits budget ladder for sensitivity-driven mixed precision
    (`quant/mixed.py`). Gradient scores are computed once on first apply
    and shared across budgets (the sensitivity pass dominates the cost)."""
    cache: dict = {}

    def mk(bits):
        def f(p, arch):
            from ..quant import mixed
            from ..sensitivity import gradient

            if "scores" not in cache:
                batches = gradient.make_synthetic_batches(
                    arch, n_batches=2, batch=2, seq=16)
                cache["scores"] = gradient.compute_sensitivity(
                    p, arch, batches)
            cfg = mixed.generate_quant_config(p, cache["scores"],
                                              target_bits=bits,
                                              ladder=ladder)
            return mixed.apply_quant_config(p, cfg)
        return {"name": f"mixed_{bits}b", "apply": f}

    return ([{"name": "baseline_fp32", "apply": _q("baseline_fp32")}]
            + [mk(b) for b in budgets])


def recovery_sweep(methods: tuple[str, ...] = ("int2", "int4"),
                   steps: int = 30, lr: float = 1e-3) -> list[dict]:
    """PTQ vs recovery-distilled vs QAT at aggressive bit widths — the
    compression-recovery ladder (beyond-reference: the reference is
    one-shot PTQ only, SURVEY §0). Each config treats the incoming dense
    params as their own teacher (`distill.py` — no labels needed), so the
    sweep composes with --hf real weights exactly like every other sweep."""
    def ptq(m):
        return {"name": f"ptq_{m}",
                "apply": lambda p, a, m=m: quant_api.quantize_params(p, m)}

    def recover(m):
        def f(p, arch, m=m):
            from ..distill import fake_quant_recovery

            q = quant_api.quantize_params(p, m)
            return fake_quant_recovery(q, p, arch, method=m,
                                       steps=steps, lr=lr)
        return {"name": f"recover_{m}", "apply": f}

    def qat(m):
        def f(p, arch, m=m):
            from ..quant.qat import qat_distill

            return qat_distill(p, p, arch, method=m, steps=steps, lr=lr,
                               preserve_sparsity=False)[0]
        return {"name": f"qat_{m}", "apply": f}

    cfgs = [{"name": "baseline_fp32", "apply": _q("baseline_fp32")}]
    for m in methods:
        cfgs += [ptq(m), recover(m), qat(m)]
    return cfgs


SWEEPS: dict[str, Callable[..., list[dict]]] = {
    "quant": lambda arch: quant_sweep(),
    "l1": lambda arch: unstructured_l1_sweep(),
    "random": lambda arch: random_pruning_sweep(),
    "experimental": experimental_pruning_sweep,
    "prune_quant": lambda arch: prune_quant_sweep(),
    "data_aware": lambda arch: data_aware_sweep(),
    "mixed": lambda arch: mixed_precision_sweep(),
    "recovery": lambda arch: recovery_sweep(),
}
