"""Whisper checkpoints (Hugging Face and OpenAI) to and from the port's
parameter tree.

The port of the JAX package's `models/convert.py`. An HF state dict (torch
tensors or numpy arrays keyed by `WhisperForConditionalGeneration`'s
parameter names) converts into the tree; linear weights are transposed
(torch stores (out, in); the tree stores (in, out) for `x @ w`). OpenAI's
original `.pt` checkpoints, bare state dicts, single and sharded
safetensors and HF snapshot directories load through `load_checkpoint`;
`load_hf_model` resolves a model name from the local npz cache or a
mounted HF hub cache. Nothing here fetches weights: where both caches
miss, `load_hf_model` raises.

safetensors files are read and written with json and struct (no
`safetensors` package), bfloat16 through torch; the reader returns CPU
tensors, `load_checkpoint` puts the tree on `device`.
"""

from __future__ import annotations

import json
import os
import struct
import types
from typing import Any, Mapping

import numpy as np
import torch

from ..config import ARCHS, WhisperArch
from .params import DEFAULT_DEVICE, tree_cast, tree_to


def _t(x) -> torch.Tensor:
    """A CPU tensor of a torch tensor or numpy array (numpy's bfloat16 of
    ml_dtypes included, whose values bfloat16 holds exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _lin(sd: Mapping[str, Any], name: str) -> dict:
    p = {"w": _t(sd[f"{name}.weight"]).t().contiguous()}
    if f"{name}.bias" in sd:
        p["b"] = _t(sd[f"{name}.bias"]).contiguous()
    return p


def _ln(sd: Mapping[str, Any], name: str) -> dict:
    return {"g": _t(sd[f"{name}.weight"]).contiguous(),
            "b": _t(sd[f"{name}.bias"]).contiguous()}


def _attn(sd: Mapping[str, Any], name: str) -> dict:
    return {
        "q": _lin(sd, f"{name}.q_proj"),
        "k": _lin(sd, f"{name}.k_proj"),
        "v": _lin(sd, f"{name}.v_proj"),
        "o": _lin(sd, f"{name}.out_proj"),
    }


def from_hf_state_dict(sd: Mapping[str, Any]) -> dict:
    """Convert an HF WhisperForConditionalGeneration state dict to a tree of
    contiguous CPU tensors."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}

    n_enc = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    n_dec = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("decoder.layers."))

    def enc_layer(i: int) -> dict:
        base = f"encoder.layers.{i}"
        return {
            "attn": _attn(sd, f"{base}.self_attn"),
            "attn_ln": _ln(sd, f"{base}.self_attn_layer_norm"),
            "fc1": _lin(sd, f"{base}.fc1"),
            "fc2": _lin(sd, f"{base}.fc2"),
            "mlp_ln": _ln(sd, f"{base}.final_layer_norm"),
        }

    def dec_layer(i: int) -> dict:
        base = f"decoder.layers.{i}"
        return {
            "attn": _attn(sd, f"{base}.self_attn"),
            "attn_ln": _ln(sd, f"{base}.self_attn_layer_norm"),
            "cross": _attn(sd, f"{base}.encoder_attn"),
            "cross_ln": _ln(sd, f"{base}.encoder_attn_layer_norm"),
            "fc1": _lin(sd, f"{base}.fc1"),
            "fc2": _lin(sd, f"{base}.fc2"),
            "mlp_ln": _ln(sd, f"{base}.final_layer_norm"),
        }

    def plain(key):
        return _t(sd[key]).contiguous()

    encoder = {
        "conv1": {"w": plain("encoder.conv1.weight"), "b": plain("encoder.conv1.bias")},
        "conv2": {"w": plain("encoder.conv2.weight"), "b": plain("encoder.conv2.bias")},
        "pos": plain("encoder.embed_positions.weight"),
        "layers": [enc_layer(i) for i in range(n_enc)],
        "ln": _ln(sd, "encoder.layer_norm"),
    }
    decoder = {
        "embed": plain("decoder.embed_tokens.weight"),
        "pos": plain("decoder.embed_positions.weight"),
        "layers": [dec_layer(i) for i in range(n_dec)],
        "ln": _ln(sd, "decoder.layer_norm"),
    }
    return {"encoder": encoder, "decoder": decoder}


def to_hf_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Inverse of `from_hf_state_dict`: tree -> HF-named state dict of
    contiguous CPU tensors (linear weights transposed back to torch's (out,
    in)), for HF tooling and `torch.save`. `proj_out.weight` is the token
    embedding itself (tied). Quantized or fused trees must be dequantized
    or unfused first."""
    from ..ops.qtensor import QTensor

    def arr(x, transpose=False):
        if isinstance(x, QTensor):
            raise ValueError("dequantize before exporting to HF format")
        a = x.detach().cpu()
        return (a.t() if transpose else a).contiguous()

    sd: dict[str, torch.Tensor] = {}

    def put_lin(name, p):
        sd[f"{name}.weight"] = arr(p["w"], transpose=True)
        if "b" in p:
            sd[f"{name}.bias"] = arr(p["b"])

    def put_ln(name, p):
        sd[f"{name}.weight"] = arr(p["g"])
        sd[f"{name}.bias"] = arr(p["b"])

    def put_attn(name, p):
        if "qkv" in p:
            raise ValueError("unfuse qkv before exporting to HF format")
        put_lin(f"{name}.q_proj", p["q"])
        put_lin(f"{name}.k_proj", p["k"])
        put_lin(f"{name}.v_proj", p["v"])
        put_lin(f"{name}.out_proj", p["o"])

    enc = params["encoder"]
    sd["model.encoder.conv1.weight"] = arr(enc["conv1"]["w"])
    sd["model.encoder.conv1.bias"] = arr(enc["conv1"]["b"])
    sd["model.encoder.conv2.weight"] = arr(enc["conv2"]["w"])
    sd["model.encoder.conv2.bias"] = arr(enc["conv2"]["b"])
    sd["model.encoder.embed_positions.weight"] = arr(enc["pos"])
    for i, layer in enumerate(enc["layers"]):
        base = f"model.encoder.layers.{i}"
        put_attn(f"{base}.self_attn", layer["attn"])
        put_ln(f"{base}.self_attn_layer_norm", layer["attn_ln"])
        put_lin(f"{base}.fc1", layer["fc1"])
        put_lin(f"{base}.fc2", layer["fc2"])
        put_ln(f"{base}.final_layer_norm", layer["mlp_ln"])
    put_ln("model.encoder.layer_norm", enc["ln"])

    dec = params["decoder"]
    sd["model.decoder.embed_tokens.weight"] = arr(dec["embed"])
    sd["model.decoder.embed_positions.weight"] = arr(dec["pos"])
    for i, layer in enumerate(dec["layers"]):
        base = f"model.decoder.layers.{i}"
        put_attn(f"{base}.self_attn", layer["attn"])
        put_ln(f"{base}.self_attn_layer_norm", layer["attn_ln"])
        put_attn(f"{base}.encoder_attn", layer["cross"])
        put_ln(f"{base}.encoder_attn_layer_norm", layer["cross_ln"])
        put_lin(f"{base}.fc1", layer["fc1"])
        put_lin(f"{base}.fc2", layer["fc2"])
        put_ln(f"{base}.final_layer_norm", layer["mlp_ln"])
    put_ln("model.decoder.layer_norm", dec["ln"])
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def arch_from_hf_config(cfg) -> WhisperArch:
    """WhisperArch of an HF WhisperConfig (or any object with its fields).

    The special-token layout follows the vocab size (WhisperConfig does not
    carry no_timestamps_token_id; generation_config does, and the loaders
    apply it on top): 51864 = English-only (<|notimestamps|> 50362, no
    language/task tokens), 51865 = v2-style multilingual (50363), >= 51866
    = v3 (+<|yue|>, everything shifts to 50364)."""
    base = ARCHS["tiny"]
    v = cfg.vocab_size
    nts = 50362 if v == 51864 else (50363 if v == 51865
                                    else 50364 if v >= 51866 else 50363)
    return base.replace(
        name=getattr(cfg, "name_or_path", "") or "hf",
        vocab_size=v,
        num_mel_bins=cfg.num_mel_bins,
        d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers,
        encoder_heads=cfg.encoder_attention_heads,
        decoder_layers=cfg.decoder_layers,
        decoder_heads=cfg.decoder_attention_heads,
        ffn_dim=cfg.encoder_ffn_dim,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        bos_token_id=cfg.eos_token_id,  # HF uses EOT as pad
        eos_token_id=cfg.eos_token_id,
        decoder_start_token_id=cfg.decoder_start_token_id,
        multilingual=v != 51864,
        # custom / test vocabs keep the (>= vocab) default: the timestamp
        # rules and the prefix specials disable
        no_timestamps_token_id=nts,
    )


# ---------------------------------------------------------------------------
# OpenAI original checkpoint format (.pt)
# ---------------------------------------------------------------------------

# OpenAI's whisper names -> HF names (blocks are handled positionally)
_OAI_FIXED = {
    "encoder.positional_embedding": "encoder.embed_positions.weight",
    "decoder.token_embedding.weight": "decoder.embed_tokens.weight",
    "decoder.positional_embedding": "decoder.embed_positions.weight",
}
_OAI_SUB = [  # ordered: longest / most specific first
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".cross_attn.query.", ".encoder_attn.q_proj."),
    (".cross_attn.key.", ".encoder_attn.k_proj."),
    (".cross_attn.value.", ".encoder_attn.v_proj."),
    (".cross_attn.out.", ".encoder_attn.out_proj."),
    (".attn_ln.", ".self_attn_layer_norm."),
    (".attn.query.", ".self_attn.q_proj."),
    (".attn.key.", ".self_attn.k_proj."),
    (".attn.value.", ".self_attn.v_proj."),
    (".attn.out.", ".self_attn.out_proj."),
    (".mlp_ln.", ".final_layer_norm."),
    (".mlp.0.", ".fc1."),
    (".mlp.2.", ".fc2."),
]


def openai_to_hf_names(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Rename an OpenAI original whisper state dict (keys like
    `encoder.blocks.0.attn.query`) to HF `WhisperForConditionalGeneration`
    names; the tensors are layout-identical (torch (out, in) linears, a
    biasless key projection)."""
    out: dict[str, Any] = {}
    for k, v in sd.items():
        nk = _OAI_FIXED.get(k)
        if nk is None:
            nk = k.replace(".blocks.", ".layers.")
            if nk.startswith("encoder.ln_post."):
                nk = nk.replace("encoder.ln_post.", "encoder.layer_norm.")
            elif nk.startswith("decoder.ln."):
                nk = nk.replace("decoder.ln.", "decoder.layer_norm.")
            for a, b in _OAI_SUB:
                nk = nk.replace(a, b)
        out[nk] = v
    return out


def _special_layout(vocab: int) -> dict:
    """Special-token ids implied by an OpenAI vocab size (as
    `arch_from_hf_config`): 51864 = English-only GPT-2 vocab, 51865 =
    multilingual v1/v2, >= 51866 = v3 (every later special shifts +1)."""
    if vocab == 51864:
        return dict(bos_token_id=50256, eos_token_id=50256,
                    decoder_start_token_id=50257,
                    no_timestamps_token_id=50362, multilingual=False)
    nts = 50364 if vocab >= 51866 else 50363
    return dict(bos_token_id=50257, eos_token_id=50257,
                decoder_start_token_id=50258,
                no_timestamps_token_id=nts, multilingual=True)


def arch_from_openai_dims(dims: Mapping[str, int],
                          name: str = "openai-pt") -> WhisperArch:
    """WhisperArch of the `dims` dict of an OpenAI `.pt` checkpoint
    ({"dims": {n_mels, n_vocab, n_audio_state, ...}, "model_state_dict":
    ...}); the FFN width is taken as 4 x d_model."""
    v = int(dims["n_vocab"])
    return ARCHS["tiny"].replace(
        name=name, vocab_size=v,
        num_mel_bins=int(dims["n_mels"]),
        d_model=int(dims["n_audio_state"]),
        encoder_layers=int(dims["n_audio_layer"]),
        encoder_heads=int(dims["n_audio_head"]),
        decoder_layers=int(dims["n_text_layer"]),
        decoder_heads=int(dims["n_text_head"]),
        ffn_dim=4 * int(dims["n_audio_state"]),
        max_source_positions=int(dims["n_audio_ctx"]),
        max_target_positions=int(dims["n_text_ctx"]),
        **_special_layout(v))


def infer_arch_from_state_dict(sd: Mapping[str, Any],
                               name: str = "inferred") -> WhisperArch:
    """WhisperArch from an HF-named state dict's shapes alone (a bare
    safetensors file with no config.json). Head counts are not in the
    shapes: an exact match of the official family (width, depths, mels)
    gives its heads, anything else d_model // 64."""
    sd_keys = {k.removeprefix("model."): v for k, v in sd.items()}
    vocab, d_model = (int(s) for s in sd_keys["decoder.embed_tokens.weight"].shape)
    enc_pos = sd_keys["encoder.embed_positions.weight"].shape[0]
    dec_pos = sd_keys["decoder.embed_positions.weight"].shape[0]
    mels = sd_keys["encoder.conv1.weight"].shape[1]
    n_enc = 1 + max(int(k.split(".")[2]) for k in sd_keys
                    if k.startswith("encoder.layers."))
    n_dec = 1 + max(int(k.split(".")[2]) for k in sd_keys
                    if k.startswith("decoder.layers."))
    ffn = sd_keys["encoder.layers.0.fc1.weight"].shape[0]
    heads = max(1, d_model // 64)
    for a in ARCHS.values():  # an exact family match wins (turbo included)
        if (a.d_model, a.encoder_layers, a.decoder_layers,
                a.num_mel_bins) == (d_model, n_enc, n_dec, mels):
            heads = a.encoder_heads
            break
    return ARCHS["tiny"].replace(
        name=name, vocab_size=vocab, num_mel_bins=int(mels),
        d_model=d_model, encoder_layers=n_enc, encoder_heads=heads,
        decoder_layers=n_dec, decoder_heads=heads, ffn_dim=int(ffn),
        max_source_positions=int(enc_pos),
        max_target_positions=int(dec_pos),
        **_special_layout(vocab))


# ---------------------------------------------------------------------------
# safetensors (json and struct, no `safetensors` package)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file: an 8-byte little-endian
    header length, a JSON header ({name: {dtype, shape, data_offsets}}),
    raw little-endian data. The file is memory-mapped and each tensor
    copied out of it, so a large file is not held twice."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + hlen)
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"unsupported safetensors dtype {meta['dtype']} for {name}")
        b0, b1 = meta["data_offsets"]
        raw = torch.from_numpy(np.array(data[b0:b1]))
        out[name] = raw.view(dtype).reshape(meta["shape"])
    return out


def write_safetensors(sd: Mapping[str, Any], path: str) -> None:
    """The inverse of `read_safetensors` for torch tensors or numpy arrays
    (float64/32/16, bfloat16, integers, bool), on any device."""
    header: dict[str, Any] = {}
    offset = 0
    blobs = []
    for name, x in sd.items():
        t = _t(x).contiguous()
        code = _ST_CODES.get(t.dtype)
        if code is None:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def hf_to_openai_names(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of `openai_to_hf_names` (HF names -> OpenAI original names);
    drops HF's tied `proj_out.weight`."""
    fixed = {v: k for k, v in _OAI_FIXED.items()}
    out: dict[str, Any] = {}
    for k, v in sd.items():
        k = k.removeprefix("model.")
        if k == "proj_out.weight":
            continue
        nk = fixed.get(k)
        if nk is None:
            nk = k.replace(".layers.", ".blocks.")
            if nk.startswith("encoder.layer_norm."):
                nk = nk.replace("encoder.layer_norm.", "encoder.ln_post.")
            elif nk.startswith("decoder.layer_norm."):
                nk = nk.replace("decoder.layer_norm.", "decoder.ln.")
            for a, b in _OAI_SUB:
                nk = nk.replace(b, a)
        out[nk] = v
    return out


def to_openai_checkpoint(params: dict, arch: WhisperArch) -> dict:
    """Tree -> the OpenAI `.pt` checkpoint structure ({"dims": ...,
    "model_state_dict": ...}, `torch.save`-able)."""
    dims = {
        "n_mels": arch.num_mel_bins, "n_vocab": arch.vocab_size,
        "n_audio_ctx": arch.max_source_positions,
        "n_audio_state": arch.d_model, "n_audio_head": arch.encoder_heads,
        "n_audio_layer": arch.encoder_layers,
        "n_text_ctx": arch.max_target_positions,
        "n_text_state": arch.d_model, "n_text_head": arch.decoder_heads,
        "n_text_layer": arch.decoder_layers,
    }
    return {"dims": dims, "model_state_dict": hf_to_openai_names(to_hf_state_dict(params))}


# ---------------------------------------------------------------------------
# Checkpoint ingestion
# ---------------------------------------------------------------------------

def _load_torch_file(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _sd_from_torch_obj(obj: Any) -> tuple[dict, WhisperArch | None]:
    """(HF-named state dict, arch or None) of a `torch.load` result: an
    OpenAI {dims, model_state_dict} wrapper, a {state_dict: ...} wrapper,
    or a bare state dict under either naming."""
    arch = None
    if isinstance(obj, Mapping) and "dims" in obj:
        arch = arch_from_openai_dims(obj["dims"])
        obj = obj.get("model_state_dict") or obj.get("state_dict")
    elif isinstance(obj, Mapping) and "state_dict" in obj and not any(
            hasattr(v, "shape") for v in obj.values()):
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError("unrecognised torch checkpoint structure")
    if any(".blocks." in k or k.endswith("positional_embedding") for k in obj):
        obj = openai_to_hf_names(obj)
    obj = dict(obj)
    if arch is not None:
        # dims carry no FFN width (4 x d_model in every real checkpoint):
        # trust the weights
        fc1 = obj.get("encoder.layers.0.fc1.weight")
        if fc1 is None:
            fc1 = obj.get("model.encoder.layers.0.fc1.weight")
        if fc1 is not None and int(fc1.shape[0]) != arch.ffn_dim:
            arch = arch.replace(ffn_dim=int(fc1.shape[0]))
    return obj, arch


def _arch_of_config(path: str) -> WhisperArch:
    with open(path) as f:
        return arch_from_hf_config(types.SimpleNamespace(**json.load(f)))


def _read_hf_dir(d: str) -> tuple[dict, WhisperArch]:
    """An HF-layout directory: config.json (optional: the shapes give the
    arch without it, so a partly populated snapshot loads) and
    model.safetensors / pytorch_model.bin, sharded or not; the alignment
    heads and <|notimestamps|> of generation_config.json. No tokenizer
    file is read. A shard the index names but the directory lacks raises."""
    sd: dict[str, Any] = {}
    for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        ip = os.path.join(d, index)
        if os.path.exists(ip):
            with open(ip) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            missing = [s for s in shards if not os.path.exists(os.path.join(d, s))]
            if missing:
                raise FileNotFoundError(f"sharded checkpoint in {d} is missing {missing}")
            for s in shards:
                sp = os.path.join(d, s)
                if s.endswith(".safetensors"):
                    sd.update(read_safetensors(sp))
                else:
                    sd.update(_sd_from_torch_obj(_load_torch_file(sp))[0])
            break
    if not sd:
        for fname in ("model.safetensors", "pytorch_model.bin", "whisper.safetensors"):
            fp = os.path.join(d, fname)
            if os.path.exists(fp):
                if fname.endswith(".safetensors"):
                    sd = read_safetensors(fp)
                else:
                    sd = _sd_from_torch_obj(_load_torch_file(fp))[0]
                break
    if not sd:  # any lone weights file in the directory
        cands = [f for f in os.listdir(d) if f.endswith((".safetensors", ".pt", ".bin"))]
        if len(cands) == 1:
            return load_checkpoint_file(os.path.join(d, cands[0]))
        raise FileNotFoundError(f"no model weights found in {d}")

    cfg_path = os.path.join(d, "config.json")
    if os.path.exists(cfg_path):
        arch = _arch_of_config(cfg_path)
        arch = arch.replace(name=os.path.basename(d.rstrip("/")) or arch.name)
    else:
        arch = infer_arch_from_state_dict(sd)
    gen_path = os.path.join(d, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            gen = json.load(f)
        heads = gen.get("alignment_heads")
        if heads:
            arch = arch.replace(alignment_heads=tuple(tuple(h) for h in heads))
        if gen.get("no_timestamps_token_id") is not None:
            arch = arch.replace(no_timestamps_token_id=int(gen["no_timestamps_token_id"]))
    return sd, arch


def load_checkpoint_file(path: str) -> tuple[dict, WhisperArch]:
    """(HF-named state dict, arch) of one checkpoint file: an OpenAI `.pt`
    (dims + model_state_dict), a bare torch state dict (`.pt` / `.bin`, HF
    or OpenAI names), or a bare `.safetensors` file (arch from a sibling
    config.json, else from the shapes)."""
    if path.endswith(".safetensors"):
        sib = os.path.join(os.path.dirname(path) or ".", "config.json")
        sd = read_safetensors(path)
        if os.path.exists(sib):
            arch = _arch_of_config(sib)
        else:
            arch = infer_arch_from_state_dict(sd, name=os.path.basename(path))
        return sd, arch
    sd, arch = _sd_from_torch_obj(_load_torch_file(path))
    if arch is None:
        arch = infer_arch_from_state_dict(sd, name=os.path.basename(path))
    return sd, arch


def load_checkpoint(path: str, dtype=torch.float32,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> tuple[dict, WhisperArch]:
    """(tree, arch) of a real-weights source: an HF snapshot or export
    directory, an OpenAI `.pt`, a bare torch state dict or a bare
    `.safetensors` file. Floating leaves are cast to `dtype` on the host,
    then the tree goes to `device` (contiguous leaves)."""
    if os.path.isdir(path):
        sd, arch = _read_hf_dir(path)
    else:
        sd, arch = load_checkpoint_file(path)
    params = tree_cast(from_hf_state_dict(sd), dtype)
    del sd
    return tree_to(params, device), arch


def find_in_hf_cache(model_name: str) -> str | None:
    """The newest snapshot directory of `model_name` (e.g.
    "openai/whisper-small") in a mounted HF hub cache that holds weights,
    found without the hub library: $HF_HUB_CACHE, $HF_HOME/hub and
    ~/.cache/huggingface/hub, in that order. A partly populated cache (no
    tokenizer, no refs) is accepted."""
    leaf = "models--" + model_name.replace("/", "--")
    weight_names = ("model.safetensors", "pytorch_model.bin",
                    "model.safetensors.index.json", "pytorch_model.bin.index.json")
    for root in _hub_roots():
        snaps = os.path.join(root, leaf, "snapshots")
        if not os.path.isdir(snaps):
            continue
        cands = [os.path.join(snaps, s) for s in sorted(os.listdir(snaps))]
        cands = [c for c in cands if os.path.isdir(c) and any(
            os.path.exists(os.path.join(c, w)) for w in weight_names)]
        if cands:
            return max(cands, key=os.path.getmtime)
    return None


def _hub_roots() -> list[str]:
    roots = []
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        roots.append(os.path.join(os.environ["HF_HOME"], "hub"))
    roots.append(os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub"))
    return roots


def checkpoint_cache_dir() -> str:
    """The local npz checkpoint cache, shared with the JAX package (its
    files are the same): $WHISPER_TPU_CACHE or
    ~/.cache/openai_whisper_compression_tpu/checkpoints."""
    return os.environ.get(
        "WHISPER_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "openai_whisper_compression_tpu", "checkpoints"))


def _cache_paths(model_name: str, cache_dir: str | None) -> tuple[str, str]:
    stem = os.path.join(cache_dir or checkpoint_cache_dir(), model_name.replace("/", "--"))
    return stem + ".npz", stem + ".arch.json"


def save_cached_model(params: dict, arch: WhisperArch,
                      model_name: str, cache_dir: str | None = None) -> str:
    """Write (params, arch) to the local npz cache; returns the npz path."""
    import dataclasses

    from ..storage.formats import save_npz

    npz, meta = _cache_paths(model_name, cache_dir)
    os.makedirs(os.path.dirname(npz), exist_ok=True)
    save_npz(params, npz)
    with open(meta, "w") as f:
        json.dump(dataclasses.asdict(arch), f, indent=2)
    return npz


def load_cached_model(model_name: str, dtype=torch.float32,
                      cache_dir: str | None = None,
                      device: str | torch.device = DEFAULT_DEVICE):
    """(params, arch) from the local npz cache on `device`; None if absent."""
    from ..storage.formats import load_npz

    npz, meta = _cache_paths(model_name, cache_dir)
    if not (os.path.exists(npz) and os.path.exists(meta)):
        return None
    with open(meta) as f:
        d = json.load(f)
    d["alignment_heads"] = tuple(tuple(h) for h in d.get("alignment_heads", ()))
    return tree_cast(load_npz(npz, device=device), dtype), WhisperArch(**d)


def load_hf_model(model_name: str, dtype=torch.float32, use_cache: bool = True,
                  cache_dir: str | None = None,
                  device: str | torch.device = DEFAULT_DEVICE):
    """(params, arch) of a pretrained Whisper by name, on `device`.

    Resolution order: (1) the local npz cache, (2) a mounted HF hub cache,
    read from its snapshot files (weights and config suffice; the tree is
    then written to (1)). The JAX package's third step, the hub through
    transformers, is not carried: nothing here fetches weights, and where
    both caches miss this raises FileNotFoundError naming them."""
    if use_cache:
        hit = load_cached_model(model_name, dtype, cache_dir, device)
        if hit is not None:
            return hit
    snap = find_in_hf_cache(model_name)
    if snap is not None:
        params, arch = load_checkpoint(snap, dtype, device)
        arch = arch.replace(name=model_name)
        if use_cache:
            try:
                save_cached_model(params, arch, model_name, cache_dir)
            except OSError:  # a cache that cannot be written must not block the load
                pass
        return params, arch
    npz, _ = _cache_paths(model_name, cache_dir)
    raise FileNotFoundError(
        f"{model_name!r} is in neither checkpoint cache: the npz cache "
        f"({npz}{'' if use_cache else ', not searched: use_cache=False'}) nor an HF hub "
        f"cache ({', '.join(_hub_roots())}); the port downloads nothing, so put the "
        "snapshot in one of them or pass a local path")
