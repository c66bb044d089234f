"""Plain PyTorch versions of the SSD scan (port of
``repro.kernels.ssd_scan.ref`` and of the Pallas kernel's arithmetic).

* :func:`ssd_ref` is the sequential recurrence, the oracle:

      h_t = exp(dt_t·a) ⊙ h_{t−1} + dt_t · x_t ⊗ B_t
      y_t = C_t · h_t

* :func:`ssd_scan_ref` is the chunked kernel's own arithmetic
  (``_ssd_kernel``): chunk by chunk in sequence, the (P, N) f32 state
  carried across chunks, batched over batch and heads. The card holds the
  CUDA kernel against it, and the kernel's wrapper runs it for CPU tensors.

Shapes: x (B, L, H, P); dt (B, L, H), post-softplus; a (H,), negative;
b, c (B, L, N), one group shared by every head. Returns y (B, L, H, P).

>>> import torch
>>> g = torch.Generator().manual_seed(0)
>>> x = torch.randn(1, 32, 2, 4, generator=g)
>>> dt = torch.nn.functional.softplus(torch.randn(1, 32, 2, generator=g))
>>> a = -torch.exp(torch.randn(2, generator=g))
>>> b, c = torch.randn(2, 1, 32, 8, generator=g)
>>> y = ssd_scan_ref(x, dt, a, b, c, chunk=16)
>>> bool(torch.allclose(y, ssd_ref(x, dt, a, b, c), atol=1e-4))
True
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, a, b, c):
    """The recurrence, one position at a time (a Python loop over L)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * a)                        # (B, H)
        upd = ((xf[:, t] * dtf[:, t, :, None])[..., None]
               * bf[:, t, None, None, :])                        # (B, H, P, N)
        state = state * decay[..., None, None] + upd
        ys.append(state @ cf[:, t, None, :, None])               # (B, H, P, 1)
    return torch.stack(ys, dim=1)[..., 0].to(x.dtype)


def ssd_scan_ref(x, dt, a, b, c, *, chunk: int = 128):
    """The kernel's chunked arithmetic, chunk by chunk. Q = min(chunk, L)
    must divide L. The exponent of the intra-chunk decay is masked to −inf
    above the diagonal before ``exp`` (the Pallas kernel masks after), so
    autograd through this function never meets 0·inf."""
    bsz, l, h, p = x.shape
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"ssd_scan_ref: sequence {l} is not a multiple of "
                         f"the chunk {q}")
    xf = x.float().permute(0, 2, 1, 3)                           # (B, H, L, P)
    dtf = dt.float().permute(0, 2, 1)                            # (B, H, L)
    bf = b.float()[:, None]                                      # (B, 1, L, N)
    cf = c.float()[:, None]
    a = a.float()[:, None]                                       # (H, 1)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for ic in range(l // q):
        sl = slice(ic * q, (ic + 1) * q)
        dtc, bc, cc = dtf[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(dtc * a, dim=-1)                      # (B, H, Q)
        xdt = xf[:, :, sl] * dtc[..., None]                      # (B, H, Q, P)
        # intra-chunk: y_d[i] = Σ_{j≤i} (C_i·B_j) e^{cum_i − cum_j} xdt_j
        scores = cc @ bc.transpose(-1, -2)                       # (B, 1, Q, Q)
        diff = cum[..., :, None] - cum[..., None, :]
        decay = torch.exp(torch.where(tri, diff, -torch.inf))
        y = (scores * decay) @ xdt                               # (B, H, Q, P)
        # inter-chunk: y_off[i] = C_i e^{cum_i} S_in
        y = y + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        # S ← e^{cum_Q} S_in + Σ_j e^{cum_Q − cum_j} xdt_j ⊗ B_j
        w = torch.exp(cum[..., -1:] - cum)[..., None] * xdt      # (B, H, Q, P)
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + w.transpose(-1, -2) @ bc)
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype)
