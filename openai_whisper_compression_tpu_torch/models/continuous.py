"""Continuous batching (slot-recycling) greedy decode.

The JAX package's `models/continuous.py`. A fixed pool of B decode slots
advances in lockstep on a GLOBAL position counter; finished utterances
retire and queued requests are admitted into their slots mid-flight, so a
batch never waits for its slowest member.

The slot trick rides the prompt machinery of `decoder_step`: a slot
admitted when the global counter is at ``g`` gets ``start[b] = g``, so its
position embeddings are sequence-relative (``pos - start``, clamped to the
table as JAX clamps), its cache reads are masked to ``start <= idx <= pos``,
and the fused self-attention kernels take the same per-slot ``start``
vector they take for prompted decoding. The self-KV cache needs no per-slot
reset: stale rows below ``start`` are never read.

The JAX module builds six jitted programs that donate the state; here they
are plain functions that mutate the state dict in place and return it, so
the caller threads the state linearly exactly as with JAX and never reuses
an old reference:

* ``chunk``: up to `chunk` calls of `decoder_step`, stopping once every
  slot is finished (one host read of `finished` a step, the early exit of
  JAX's while loop), with the suppress biases, the forced prefix, the
  per-slot `cap` and EOT padding of JAX's loop body;
* ``admit``: mel → encoder → transposed cross-KV for up to A arrivals in
  one pass, their rows written into their slots with ``index_copy_``
  (masked-off lanes leave their slot untouched);
* ``encode_stage`` / ``admit_from_stage``: prefill disaggregation, one
  large-batch encode into a staging cross-KV, then pure row copies;
* ``rebase``: roll tokens and every cache tensor down the position axis in
  place, so the global counter stays inside the static cache window.

``pos`` is a host int in the state (the JAX state holds a device scalar):
the decode step takes it from the host, and the packed `sync` snapshot
carries it to the retirement code as JAX's does.

Host orchestration (slot bookkeeping, retirement, the admission queue)
lives in the package's ``continuous.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..config import HOP_LENGTH, DecodeConfig, WhisperArch
from . import cache as kv_cache
from .decode import _suppress_bias, cross_kvs_for, decoder_step, forced_prefix
from .params import DEFAULT_DEVICE, resolve_device

Params = dict[str, Any]

PCM16_SCALE = 1.0 / 32767.0   # the int16 admit wire, as the JAX admit scales


@dataclasses.dataclass(frozen=True)
class CBPlan:
    """Static geometry shared by the engine fns and the host orchestrator."""

    batch: int
    chunk: int
    admit_lanes: int
    cache_len: int
    prefix: tuple[int, ...]
    p_len: int
    max_new: int
    n_samples: int

    @property
    def max_rel(self) -> int:
        """Highest relative position a slot can reach (exclusive)."""
        return self.p_len + self.max_new


def _check_cfg(arch: WhisperArch, cfg: DecodeConfig) -> None:
    from .decode import _timestamps_enabled

    if cfg.beam_size > 1:
        raise ValueError("continuous batching is greedy-only (beam_size=1)")
    if _timestamps_enabled(arch, cfg):
        raise ValueError(
            "continuous batching does not support timestamp decoding; it "
            "targets the short-utterance serving path (notimestamps=True)")
    if not cfg.cross_pallas:
        # the admit row copies are laid out on the transposed CrossKV rows
        raise ValueError(
            "continuous batching requires cross_pallas=True (the admit "
            "scatter is laid out on the transposed CrossKV rows)")


def _host(x) -> np.ndarray:
    """A host numpy copy of an index/mask argument (numpy, list or tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x)


def _copy_rows(state_cross: list, new_cross: list, rows: torch.Tensor,
               src_rows: torch.Tensor) -> None:
    """Write new_cross's (B·H) rows `src_rows` into the state's CrossKV
    tensors at `rows`, in place, for every layer and field (the int8 / int4
    scales too)."""
    for kv, nkv in zip(state_cross, new_cross):
        for name in ("k_t", "v_t", "k_scale", "v_scale"):
            cur = getattr(kv, name)
            if cur is not None:
                cur.index_copy_(0, rows, getattr(nkv, name).index_select(0, src_rows))


def make_cb_fns(arch: WhisperArch, cfg: DecodeConfig, batch: int,
                chunk: int = 16, admit_lanes: int = 4,
                cache_len: int | None = None, n_mels: int | None = None,
                fast_mel: bool = True, merge_at: int | None = None,
                merge_factor: int = 2, fast_gelu: bool = False,
                transfer: str = "float32", overlap: bool = False,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> tuple[CBPlan, dict[str, Callable]]:
    """Build the six continuous-batching functions on `device` (the card
    unless the caller names another; `params` must live there).

    Returns (plan, fns) where fns has:
      init(params)                                   -> state
      chunk(params, state)                           -> (state, sync)
      admit(params, state, wavs, slots, mask, caps)  -> state
      encode_stage(params, wavs)                     -> stage
      admit_from_stage(state, stage, lanes, slots, mask, caps) -> state
      rebase(state, shift)                           -> state
    chunk/admit/admit_from_stage/rebase mutate `state` in place and return
    it (JAX donates it): callers thread state linearly and never reuse a
    pre-call reference. `sync` is a fresh packed snapshot
    [pos, finished..., start..., tokens...] (int64) that survives later
    calls. state is a dict: {tokens (B, L) int64, cache, cross (CrossKV per
    layer), pos (host int), start (B,) int32, cap (B,) int32, finished (B,)
    bool}. `finished` doubles as "slot free": unoccupied slots sit
    finished, feeding EOT. `cap` is the per-request token budget: slot b
    generates at most cap[b] tokens, exactly `greedy_decode` with
    max_new_tokens=cap[b]. slots / lanes / mask / caps are host arrays (or
    tensors, read back once). `wavs` (A, n_samples): float32, or int16
    PCM under transfer="int16" (scaled by 1/32767 on the device; a floating
    tensor there raises, where the JAX admit would scale floats into
    near-silence). The JAX function's `use_pallas_mel` has no counterpart:
    the mel runs its kernel on the card and the plain version elsewhere."""
    _check_cfg(arch, cfg)
    device = resolve_device(device)
    admit_lanes = min(admit_lanes, batch)
    prefix = tuple(forced_prefix(arch, cfg))
    p_len = len(prefix)
    # relative positions index the (max_target_positions,) embedding table;
    # the GLOBAL cache window may be longer (it's rebased, never embedded)
    max_new = min(cfg.max_new_tokens, arch.max_target_positions - p_len)
    # the global counter must fit a full slot lifetime plus one whole chunk
    # between rebase checks, two under the overlapped host loop, whose
    # rebase decisions run one chunk behind (64-aligned)
    need = p_len + max_new + (2 * chunk if overlap else chunk) + 1
    cache_len = cache_len or -(-need // 64) * 64
    if cache_len < need:
        raise ValueError(f"cache_len {cache_len} < required {need}")
    n_mels = n_mels or arch.num_mel_bins
    n_samples = arch.max_source_positions * 2 * HOP_LENGTH
    plan = CBPlan(batch=batch, chunk=chunk, admit_lanes=admit_lanes,
                  cache_len=cache_len, prefix=prefix, p_len=p_len,
                  max_new=max_new, n_samples=n_samples)

    eot = arch.eos_token_id
    sup = torch.from_numpy(_suppress_bias(arch, tuple(cfg.suppress_tokens))).to(device)
    begin_sup = torch.from_numpy(
        _suppress_bias(arch, tuple(cfg.begin_suppress_tokens))).to(device)
    prefix_arr = torch.tensor(prefix, dtype=torch.long, device=device)
    dft_dtype = torch.bfloat16 if fast_mel else torch.float32

    if transfer not in ("float32", "int16"):
        raise ValueError(f"transfer must be float32|int16, got {transfer!r}")

    def _encode(params, wavs):
        """mel -> encoder -> cross-KV (pooled or merged as cfg asks) for an
        (A, n_samples) batch: make_transcribe_fn's frontend."""
        from ..audio import features
        from .whisper import encode

        wavs = torch.as_tensor(wavs, device=device)
        if transfer == "int16":
            if wavs.is_floating_point():
                raise ValueError(
                    "transfer='int16' takes int16 PCM; got a floating "
                    f"{wavs.dtype} batch (stage() builds the int16 pool)")
            wavs = wavs.to(torch.float32) * PCM16_SCALE
        else:
            wavs = wavs.to(torch.float32)
        mel = features.preprocess(wavs, n_mels=n_mels, length=n_samples,
                                  dft_dtype=dft_dtype).to(params["encoder"]["ln"]["g"].dtype)
        enc = encode(params, arch, mel, merge_at=merge_at,
                     merge_factor=merge_factor, fast_gelu=fast_gelu)
        return cross_kvs_for(params, arch, enc, cfg)

    @torch.inference_mode()
    def init_fn(params):
        cross = _encode(params, torch.zeros((batch, n_samples),
                                            dtype=torch.int16 if transfer == "int16"
                                            else torch.float32, device=device))
        cache = kv_cache.init_cache(params, arch, batch, cache_len,
                                    dtype=params["encoder"]["ln"]["g"].dtype, device=device,
                                    int8=cfg.kv_int8)
        return {
            "tokens": torch.full((batch, cache_len), eot, dtype=torch.long,
                                 device=device),
            "cache": cache,
            "cross": cross,
            "pos": 0,
            "start": torch.zeros((batch,), dtype=torch.int32, device=device),
            "cap": torch.full((batch,), max_new, dtype=torch.int32, device=device),
            "finished": torch.ones((batch,), dtype=torch.bool, device=device),
        }

    @torch.inference_mode()
    def chunk_fn(params, state):
        tokens, cache, cross = state["tokens"], state["cache"], state["cross"]
        start, cap = state["start"], state["cap"]
        finished, pos = state["finished"], state["pos"]
        for _ in range(chunk):
            if bool(finished.all()):        # the one host read a step
                break
            logits = decoder_step(params, arch, tokens[:, pos], pos, cache, cross,
                                  start=start, self_pallas=cfg.self_pallas) + sup
            rel_next = pos + 1 - start                                 # (B,)
            logits = torch.where((rel_next == p_len)[:, None],
                                 logits + begin_sup, logits)
            nxt = torch.argmax(logits, dim=-1)
            # forced prefix for freshly admitted slots (stepped, not
            # prefilled: per-slot offsets rule out the batched prefill)
            in_prefix = rel_next < p_len
            forced = prefix_arr[rel_next.clamp(0, p_len - 1).long()]
            nxt = torch.where(in_prefix, forced, nxt)
            # a slot writes at most cap[b] generated tokens, then pads EOT
            capped = rel_next >= p_len + cap
            nxt = torch.where(finished | capped, torch.full_like(nxt, eot), nxt)
            finished = finished | ((nxt == eot) & ~in_prefix)
            tokens[:, pos + 1] = nxt
            pos += 1
        state["finished"], state["pos"] = finished, pos
        # [pos, finished..., start..., tokens...]: ONE host readback per
        # chunk, self-consistent with the start the tokens were written at
        sync = torch.cat([tokens.new_full((1,), pos), finished.long(),
                          start.long(), tokens.reshape(-1)])
        return state, sync

    def _arm(state, slots: np.ndarray, mask: np.ndarray, caps: np.ndarray) -> None:
        """The masked lanes' slots: the first prefix token at pos, start =
        pos, the clipped cap, not finished."""
        m_slots = torch.from_numpy(slots[mask].astype(np.int64)).to(device)
        state["tokens"][m_slots, state["pos"]] = prefix[0]
        state["start"][m_slots] = state["pos"]
        state["cap"][m_slots] = torch.from_numpy(
            np.clip(caps[mask], 1, max_new).astype(np.int32)).to(device)
        state["finished"][m_slots] = False

    def _rows(heads: int, idx: np.ndarray) -> torch.Tensor:
        """The (B·H) rows of entries `idx`, heads consecutive."""
        rows = (idx.astype(np.int64)[:, None] * heads + np.arange(heads)[None, :])
        return torch.from_numpy(rows.reshape(-1)).to(device)

    @torch.inference_mode()
    def admit_fn(params, state, wavs, slots, mask, caps):
        """Admit up to A requests: wavs (A, n_samples), slots (A,) DISTINCT
        slot indices (host-guaranteed), mask (A,) bool (masked-off lanes
        leave their slot untouched), caps (A,) per-request token budgets
        (clipped to plan.max_new)."""
        slots, mask, caps = _host(slots), _host(mask).astype(bool), _host(caps)
        new_cross = _encode(params, wavs)
        if mask.any():
            heads = state["cross"][0].k_t.shape[0] // batch
            lanes = np.nonzero(mask)[0]
            _copy_rows(state["cross"], new_cross, _rows(heads, slots[lanes]),
                       _rows(heads, lanes))
            _arm(state, slots, mask, caps)
        return state

    @torch.inference_mode()
    def encode_stage_fn(params, wavs):
        """Prefill disaggregation: encode a STAGE block of up to E arrivals
        in ONE large-batch pass into a staging cross-KV; admits then become
        pure row copies (admit_from_stage)."""
        return _encode(params, wavs)

    @torch.inference_mode()
    def admit_from_stage_fn(state, stage, lanes, slots, mask, caps):
        """Admit up to A requests whose cross-KV already sits in `stage`
        (encode_stage output): lanes (A,) stage block-row indices, slots
        (A,) DISTINCT slot indices, mask (A,) bool, caps (A,). Pure row
        copies, no encoder work."""
        lanes, slots = _host(lanes), _host(slots)
        mask, caps = _host(mask).astype(bool), _host(caps)
        if mask.any():
            heads = state["cross"][0].k_t.shape[0] // batch
            _copy_rows(state["cross"], stage, _rows(heads, slots[mask]),
                       _rows(heads, lanes[mask]))
            _arm(state, slots, mask, caps)
        return state

    @torch.inference_mode()
    def rebase_fn(state, shift):
        """Shift the global window down by `shift` (host-computed: the
        minimum start over OCCUPIED slots), in place. Rolled-in tail rows
        are never read: cache reads are masked to start <= idx <= pos."""
        shift = int(shift)
        if shift:
            state["tokens"].copy_(torch.roll(state["tokens"], -shift, dims=1))
            for entry in state["cache"]:
                for t in entry.values():
                    t.copy_(torch.roll(t, -shift, dims=2))
        state["pos"] -= shift
        state["start"].copy_((state["start"] - shift).clamp_min(0))
        return state

    return plan, {"init": init_fn, "chunk": chunk_fn, "admit": admit_fn,
                  "rebase": rebase_fn, "encode_stage": encode_stage_fn,
                  "admit_from_stage": admit_from_stage_fn}


def gen_tokens_of_row(row: np.ndarray, start: int, p_len: int, cap: int,
                      eot: int) -> np.ndarray:
    """Host-side retirement: the generated tokens (incl. a final EOT the
    model actually emitted — `_gen_lengths` semantics) of a finished slot
    from the global token buffer. `cap` is the slot's token budget; the EOT
    the engine force-pads at index `cap` is budget exhaustion, not an
    emission, and is excluded — matching standalone `greedy_decode` with
    max_new_tokens=cap, which truncates without appending EOT."""
    gen = row[start + p_len: start + p_len + cap]
    hits = np.nonzero(gen == eot)[0]
    n = int(hits[0]) + 1 if hits.size else gen.shape[0]
    return gen[:n]
