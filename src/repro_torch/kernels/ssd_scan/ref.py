"""Plain PyTorch versions of the SSD scan (port of
``repro.kernels.ssd_scan.ref`` and of the Pallas kernel's arithmetic).

* :func:`ssd_ref` is the sequential recurrence, the oracle:

      h_t = exp(dt_t·a) ⊙ h_{t−1} + dt_t · x_t ⊗ B_t
      y_t = C_t · h_t

* :func:`ssd_scan_ref` is the chunked kernel's own arithmetic
  (``_ssd_kernel``): chunk by chunk in sequence, the (P, N) f32 state
  carried across chunks, batched over batch and heads. The card holds the
  CUDA kernel against it, and the kernel's wrapper runs it for CPU tensors.

* :func:`ssd_scan_phases_ref` is the state-passing form the CUDA kernels
  compute, the composition of their phases' plain versions:
  :func:`chunk_cum_ref` and :func:`chunk_gram_ref` (cb),
  :func:`chunk_states_ref`, :func:`state_pass_ref` and
  :func:`chunk_scan_ref`. The card holds each CUDA launch against the plain
  versions of its phases.

Shapes: x (B, L, H, P); dt (B, L, H), post-softplus; a (H,), negative;
b, c (B, L, N), one group shared by every head. Returns y (B, L, H, P).
Per chunk, C = L/Q chunks of Q rows.

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


def _chunks(t, q):
    """(B, L, ...) → (B, C, Q, ...), float32."""
    return t.float().reshape(t.shape[0], t.shape[1] // q, q, *t.shape[2:])


def _xdt(x, dt, q):
    """x·dt per chunk and head: (B, C, H, Q, P)."""
    return (_chunks(x, q) * _chunks(dt, q)[..., None]).permute(0, 1, 3, 2, 4)


def chunk_cum_ref(dt, a, q):
    """cum (B, C, H, Q): the prefix sums of dt·a within each chunk."""
    da = _chunks(dt, q).permute(0, 1, 3, 2) * a.float()[:, None]
    return torch.cumsum(da, dim=-1)


def chunk_gram_ref(b, c, q):
    """C·Bᵀ per chunk, (B, C, Q, Q), zero above the diagonal; every head
    shares it."""
    return torch.tril(_chunks(c, q) @ _chunks(b, q).transpose(-1, -2))


def chunk_states_ref(x, dt, b, cum):
    """Each chunk's own state S_c = Σ_j e^{cum_last − cum_j} xdt_j ⊗ B_j,
    (B, C, H, P, N)."""
    q = cum.shape[-1]
    w = torch.exp(cum[..., -1:] - cum)[..., None] * _xdt(x, dt, q)
    return w.transpose(-1, -2) @ _chunks(b, q)[:, :, None]


def state_pass_ref(states, cum):
    """The states entering each chunk, (B, C, H, P, N): S_in[0] = 0,
    S_in[c] = e^{cum_last[c−1]} S_in[c−1] + S_{c−1}, in sequence."""
    g = torch.exp(cum[..., -1])                                  # (B, C, H)
    state = torch.zeros_like(states[:, 0])
    entering = []
    for ic in range(states.shape[1]):
        entering.append(state)
        state = g[:, ic, :, None, None] * state + states[:, ic]
    return torch.stack(entering, dim=1)


def chunk_scan_ref(x, dt, c, gram, cum, states_in):
    """y (B, L, H, P) from each chunk's C·Bᵀ (``gram``, lower triangle),
    prefix sums and entering state:

        y_i = Σ_{j≤i} G_ij e^{cum_i − cum_j} xdt_j + e^{cum_i} C_i · S_in

    The decay's exponent is masked to −inf above the diagonal before
    ``exp`` (the Pallas kernel masks after), so autograd through this
    function never meets 0·inf."""
    q = cum.shape[-1]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.exp(torch.where(tri, diff, -torch.inf))     # (B, C, H, Q, Q)
    y = (gram[:, :, None] * decay) @ _xdt(x, dt, q)              # (B, C, H, Q, P)
    y = y + torch.exp(cum)[..., None] * (
        _chunks(c, q)[:, :, None] @ states_in.transpose(-1, -2))
    bsz, l, h, p = x.shape
    return y.permute(0, 1, 3, 2, 4).reshape(bsz, l, h, p).to(x.dtype)


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


def ssd_scan_phases_ref(x, dt, a, b, c, *, chunk: int = 128):
    """The CUDA kernels' state-passing arithmetic, phase by phase; equal to
    :func:`ssd_scan_ref` up to f32 rounding. Q = min(chunk, L) must divide
    L."""
    l = x.shape[1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"ssd_scan_phases_ref: sequence {l} is not a "
                         f"multiple of the chunk {q}")
    cum = chunk_cum_ref(dt, a, q)
    states_in = state_pass_ref(chunk_states_ref(x, dt, b, cum), cum)
    return chunk_scan_ref(x, dt, c, chunk_gram_ref(b, c, q), cum, states_in)
