"""Mamba-2 block, SSD (state-space duality) form [arXiv:2405.21060] (port of
``repro.models.ssm``, training path).

Training runs the chunked SSD algorithm: dense products within a chunk
against a lower-triangular decay matrix, and a short recurrence over the
per-chunk summary states. With ``cfg.ssm_backend == "pallas"`` (the JAX
package's name, kept so configs cross unchanged) the forward runs the SSD
scan kernel of ``repro_torch.kernels.ssd_scan`` and the backward
differentiates :func:`ssd_chunked` at the saved inputs, as the JAX
package's ``custom_vjp`` does. The decode cache comes with serving
(ROADMAP A19).

Shapes: d_inner = expand·d_model, H = d_inner / P heads of P = head dim,
state size N, one B/C group shared by every head.

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.configs import smoke_config
>>> cfg = smoke_config("mamba2-370m")
>>> p = init_ssm(jr.PRNGKey(0, device="cpu"), cfg)
>>> sorted(p)
['a_log', 'conv', 'd_skip', 'dt_bias', 'in_proj', 'norm', 'out_proj']
>>> x = torch.zeros(1, cfg.ssm_chunk, cfg.d_model)
>>> tuple(apply_ssm(p, cfg, x).shape) == (1, cfg.ssm_chunk, cfg.d_model)
True
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels.ssd_scan.kernel import ssd_scan
from .layers import _normal, apply_conv1d, apply_rmsnorm, init_conv1d
from .layers import init_rmsnorm, split


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace``'s formula, start·(1 − s) + stop·s with
    s = iota / (num − 1), in f32: bit for bit at 8 and 32 points (the narrow
    test model's and mamba2-370m's heads), within an ulp elsewhere, where
    ``torch.linspace`` differs at 9 of 32 points."""
    div = num - 1
    step = (torch.arange(div, dtype=torch.float32, device=device)
            / torch.full((div,), float(div), device=device))
    head = start * (1 - step) + stop * step
    return torch.cat([head, torch.full((1,), stop, device=device)])


def init_ssm(key, cfg: ArchConfig):
    dm, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    keys = split(key, 5)
    lead = key.shape[:-1]

    def per_head(v):
        return v.expand(lead + (h,)).clone()

    return {
        # in_proj → [z (gate, di), x (di), B (n), C (n), dt (h)]
        "in_proj": _normal(keys[0], (dm, 2 * di + 2 * n + h), dm ** -0.5),
        "out_proj": _normal(keys[1], (di, dm), di ** -0.5),
        "a_log": per_head(torch.log(_linspace(1.0, 16.0, h, key.device))),
        "d_skip": per_head(torch.ones(h, device=key.device)),
        "dt_bias": per_head(torch.zeros(h, device=key.device)),
        "conv": init_conv1d(keys[2], di + 2 * n, cfg.ssm_conv_width),
        "norm": init_rmsnorm(key, di),
    }


def _segsum(x):
    """Stable segment sum: out[..., i, j] = Σ_{j < k ≤ i} x[..., k],
    x: (..., q) → (..., q, q), −inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk):
    """Chunked SSD scan, plain tensor math (the reference backend, and the
    function the kernel's backward differentiates).

    x: (B, L, H, P) · dt: (B, L, H) (post-softplus) · a: (H,) (negative) ·
    b, c: (B, L, N) → y: (B, L, H, P). The JAX package's three-operand
    einsums are written as pairwise products whose largest intermediate is
    (B, C, H, Q, Q).
    """
    bsz, l, h, pdim = x.shape
    n = b.shape[-1]
    q = chunk
    nc = l // q
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")

    out_dtype = x.dtype
    # f32 throughout: the cumulative decay products underflow in bf16
    x, b, c, dt = x.float(), b.float(), c.float(), dt.float()

    da = dt * a                                               # (B, L, H), ≤ 0
    xdt = x * dt[..., None]

    xc = xdt.reshape(bsz, nc, q, h, pdim).permute(0, 1, 3, 2, 4)  # (B,C,H,Q,P)
    dac = da.reshape(bsz, nc, q, h).permute(0, 1, 3, 2)          # (B,C,H,Q)
    bc = b.reshape(bsz, nc, q, n)                                 # (B,C,Q,N)
    cc = c.reshape(bsz, nc, q, n)

    da_cum = torch.cumsum(dac, dim=-1)                        # (B,C,H,Q)

    # 1) intra-chunk (diagonal blocks): Y_d[i] = Σ_{j≤i} C_i·B_j e^{ΣdA} x_j
    ldecay = torch.exp(_segsum(dac))                          # (B,C,H,Q,Q)
    scores = cc @ bc.transpose(-1, -2)                        # (B,C,Q,Q)
    y_diag = (scores[:, :, None] * ldecay) @ xc               # (B,C,H,Q,P)

    # 2) chunk summary states: S_c = Σ_j e^{Σ_{j<k≤Q} dA} B_j x_j
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)       # (B,C,H,Q)
    states = ((decay_states[..., None] * xc).transpose(-1, -2)
              @ bc[:, :, None])                               # (B,C,H,P,N)

    # 3) inter-chunk recurrence over the summary states
    chunk_decay = torch.exp(da_cum[..., -1])                  # (B,C,H)
    carry = torch.zeros((bsz, h, pdim, n), dtype=x.dtype, device=x.device)
    entering = []
    for ic in range(nc):
        entering.append(carry)                                # state *entering*
        carry = carry * chunk_decay[:, ic, :, None, None] + states[:, ic]
    states_in = torch.stack(entering, dim=1)                  # (B,C,H,P,N)

    # 4) inter-chunk output: Y_off[i] = C_i e^{Σ_{0<k≤i} dA} S_in
    in_decay = torch.exp(da_cum)                              # (B,C,H,Q)
    y_off = ((cc[:, :, None] @ states_in.transpose(-1, -2))
             * in_decay[..., None])                           # (B,C,H,Q,P)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4)               # (B,C,Q,H,P)
    return y.reshape(bsz, l, h, pdim).to(out_dtype)


class _SSDScan(torch.autograd.Function):
    """Forward: the SSD scan kernel (its plain version for CPU tensors).
    Backward: the gradient of :func:`ssd_chunked` at the saved inputs (the
    JAX package has no backward kernel for the scan)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        # x, b, c are views of the conv output: the kernel reads them
        # through their strides
        return ssd_scan(x, dt.contiguous(), a.contiguous(), b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            args = tuple(t.detach().requires_grad_()
                         for t in ctx.saved_tensors)
            out = ssd_chunked(*args, ctx.chunk)
            grads = torch.autograd.grad(out, args, g)
        return (*grads, None)


def _ssd_pallas(xh, dt, a, b, c, chunk):
    """SSD mixing through the scan kernel (``cfg.ssm_backend="pallas"``):
    forward kernel, backward the chunked reference's gradient."""
    return _SSDScan.apply(xh, dt, a, b, c, chunk)


def _silu(x):
    # x·sigmoid(x) rounds as jax.nn.silu does on 99.6% of inputs, F.silu on
    # 77% (both within an ulp)
    return x * torch.sigmoid(x)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch.logaddexp rounds as it does
    # on 93% of inputs, F.softplus on 88% (both within an ulp)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_ssm(p, cfg: ArchConfig, x):
    """Full-sequence Mamba2 block. x: (B, S, D) → (B, S, D)."""
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"]
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    xbc = _silu(apply_conv1d(p["conv"], xbc))
    xs, b, c = torch.split(xbc, [di, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(*xs.shape[:2], h, pd)
    if cfg.ssm_backend == "pallas":
        y = _ssd_pallas(xh, dt, a, b, c, cfg.ssm_chunk)
    else:
        y = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk)
    y = y + p["d_skip"][:, None].to(y.dtype) * xh
    y = y.reshape(xs.shape)
    y = apply_rmsnorm(p["norm"], y * _silu(z), cfg.norm_eps)
    return y @ p["out_proj"]
