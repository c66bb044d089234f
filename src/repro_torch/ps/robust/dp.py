"""Private uplinks: per-worker l2 clipping and Gaussian noise (port of
``repro.ps.robust.dp``).

Each worker clips its whole uplink (every leaf jointly) to an l2 ball of
radius ``clip`` and adds isotropic Gaussian noise with stddev
``sigma · clip``: the Gaussian mechanism (this module is the mechanism,
not the privacy accountant). The engine runs it after any attack and
before compression; the noise keys are folded off the per-(round, worker)
codec keys, as in the JAX package, so reruns and resumes add the same
noise.

Examples
--------
>>> import torch
>>> from repro_torch import random as jr
>>> dp = DPUplink(clip=1.0, sigma=0.0)
>>> z = (torch.tensor([[3.0, 4.0], [0.3, 0.4]]),)
>>> out = dp.apply(z, jr.split(jr.PRNGKey(0, device="cpu"), 2))
>>> [round(float(r.norm()), 6) for r in out[0]]
[1.0, 0.5]
"""
from __future__ import annotations

import dataclasses
import zlib

import torch

from ... import random as jr
from ...core.tree import per_worker
from ...kernels.sync_compress.ref import f32, sqrt_f32


@dataclasses.dataclass(frozen=True)
class DPUplink:
    """l2-clip + Gaussian-noise transform for worker uplinks: leaves are
    jointly scaled by ``min(1, clip/‖z̃‖₂)``, then (for ``sigma > 0``) get
    noise of stddev ``sigma · clip`` per coordinate."""

    clip: float
    sigma: float = 0.0

    def __post_init__(self):
        if self.clip <= 0:
            raise ValueError(f"clip must be > 0, got {self.clip}")
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")

    @property
    def name(self) -> str:
        return f"dp(clip={self.clip},sigma={self.sigma})"

    @property
    def fingerprint(self) -> int:
        return zlib.crc32(self.name.encode()) & 0xFFFFFFFF

    def apply(self, payload, rngs):
        """Privatize a tuple of worker-stacked leaves with ``(M, 2)``
        per-worker keys (each worker's leaf keys are ``split(key, L)``)."""
        sq = sum(z.float().square().reshape(z.shape[0], -1).sum(dim=1)
                 for z in payload)                            # (M,)
        norm = sqrt_f32(sq)
        # a true division (``float / tensor`` multiplies by the reciprocal)
        clip = torch.full_like(norm, f32(self.clip))
        factor = torch.clamp(clip / torch.clamp(norm, min=1e-30), max=1.0)
        if self.sigma:
            keys = jr.split(rngs, len(payload))               # (M, L, 2)
            std = f32(self.sigma * self.clip)
        outs = []
        for li, z in enumerate(payload):
            out = per_worker(factor, z).to(z.dtype) * z
            if self.sigma:
                noise = jr.normal(keys[:, li], z.shape[1:]).to(z.dtype)
                out = out + std * noise
            outs.append(out)
        return tuple(outs)
