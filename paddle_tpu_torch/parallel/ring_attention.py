"""Attention over [B, T, H, D] heads (counterpart of
``paddle_tpu/parallel/ring_attention.py``). The port has the exact
single-device form, ``reference_attention``, which the
``multi_head_attention`` layer calls; the ring and Ulysses backends, which
shard long sequences over a mesh, come with the mesh.
"""

from __future__ import annotations

import torch


def reference_attention(q, k, v, causal=False, scale=None, seg_q=None,
                        seg_kv=None):
    """Single-device exact attention. q [B, T, H, D], k and v [B, Tk, H,
    D]; scores in float32 (JAX's preferred_element_type), masked by -1e30
    where ``causal`` puts a key after its query and, given seg_q/seg_kv
    ([B, T] packed-row segment ids), across segments."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bqhk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        T, Tk = s.shape[1], s.shape[3]
        keep = (torch.arange(T, device=s.device)[:, None]
                >= torch.arange(Tk, device=s.device)[None, :])
        s = torch.where(keep[None, :, None, :], s, s.new_tensor(-1e30))
    if seg_q is not None:
        same = seg_q[:, :, None] == seg_kv[:, None, :]
        s = torch.where(same[:, :, None, :], s, s.new_tensor(-1e30))
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqhk,bkhd->bqhd", a, v)
