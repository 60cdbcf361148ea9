"""Encoder token merging: shrink the attended sequence before the cross-KV.

The JAX package's `models/merge.py`. Every decode step streams the whole
cross-KV, and the 1500 encoder frames (50 Hz) are highly redundant, so
merging similar frames cuts both the stream and its memory, at some loss of
agreement:

- `pool_tokens`: stride-k mean pooling over frames (data-independent);
- `tome_merge`: ToMe-style bipartite soft matching (Bolya et al., ICLR
  2023): even frames form set A, odd frames set B; the r A-frames most
  similar to their best B partner are absorbed into it (size-weighted
  mean), the rest kept. Output (B, S - r, D).

The cross-KV carries no positional encoding and softmax attention does not
depend on the order of the attended axis, so the merged sequence is simply
concat(B partners, surviving A frames). `models.decode` applies these when
`DecodeConfig.cross_kv_pool > 1` or `cross_kv_merge > 0`; the cross-KV
precompute and the kernels take any S (padded to `pad_cross_len(S)` and
masked past it). `models.whisper.encode(merge_at=)` pools inside the
encoder instead; the two compose.
"""

from __future__ import annotations

import torch


def pool_tokens(enc_out: torch.Tensor, stride: int) -> torch.Tensor:
    """Stride-`stride` mean pooling over the frame axis: (B, S, D) ->
    (B, ceil(S / stride), D), a ragged tail pooled over the frames left."""
    if stride <= 1:
        return enc_out
    b, s, d = enc_out.shape
    s_full = (s // stride) * stride
    x = enc_out[:, :s_full].reshape(b, s_full // stride, stride, d).mean(2)
    if s != s_full:
        x = torch.cat([x, enc_out[:, s_full:].mean(1, keepdim=True)], dim=1)
    return x.to(enc_out.dtype)


def tome_merge(enc_out: torch.Tensor, r: int) -> torch.Tensor:
    """ToMe-style bipartite merge of the `r` most similar frame pairs:
    (B, S, D) -> (B, S - r, D), 0 <= r <= S // 2. Each A frame's partner is
    its best-cosine B frame (the first on a tie, as `jnp.argmax`); the A
    frames are ranked by that similarity with a stable sort (ties in frame
    order, as `jnp.argsort`), and the first r are absorbed: a partner that
    absorbs k frames becomes the mean of all k + 1, in f32 (the JAX
    package's one-hot contraction)."""
    if r <= 0:
        return enc_out
    b, s, d = enc_out.shape
    if r > s // 2:
        raise ValueError(f"merge_r={r} exceeds the bipartite half "
                         f"{s // 2} of S={s}")
    a, bset = enc_out[:, 0::2], enc_out[:, 1::2]          # (B, na, D), (B, nb, D)
    nb = bset.shape[1]
    an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-6)
    bn = bset / (torch.linalg.vector_norm(bset, dim=-1, keepdim=True) + 1e-6)
    sim = torch.matmul(an, bn.transpose(1, 2))            # (B, na, nb)
    best = sim.amax(dim=-1)
    partner = torch.argmax(sim, dim=-1)
    order = torch.argsort(-best, dim=-1, stable=True)     # merge-first ranking
    merged_idx, kept_idx = order[:, :r], order[:, r:]

    def rows(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, d))

    sel = torch.nn.functional.one_hot(torch.gather(partner, 1, merged_idx),
                                      nb).to(torch.float32)           # (B, r, nb)
    add = torch.matmul(sel.transpose(1, 2), rows(a, merged_idx).float())  # (B, nb, D)
    merged_b = (bset.float() + add) / (1.0 + sel.sum(dim=1))[..., None]
    return torch.cat([merged_b.to(enc_out.dtype), rows(a, kept_idx)], dim=1)


def merge_encoder_tokens(enc_out: torch.Tensor, pool: int = 1,
                         merge_r: int = 0) -> torch.Tensor:
    """Apply the configured token-merging strategy (merge_r wins)."""
    if merge_r > 0:
        return tome_merge(enc_out, merge_r)
    return pool_tokens(enc_out, pool)
