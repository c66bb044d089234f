"""Plain PyTorch attention, the twin of the flash kernel (port of
``repro.kernels.flash_attention.ref``).

Materializes the full (S, T) logit matrix: O(S·T) memory, the exact
reference for the kernel and the function the model's backward
differentiates.

>>> import torch
>>> q = torch.randn(1, 2, 5, 8)
>>> attention_ref(q, q[:, :1], q[:, :1]).shape
torch.Size([1, 2, 5, 8])
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """q: (B, H, S, D); k, v: (B, Kh, T, D) with H % Kh == 0 (GQA).

    Returns (B, H, S, D). Softmax in f32.
    """
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5

    qg = q.reshape(b, kh, g, s, d)
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v)
    return out.reshape(b, h, s, d)
