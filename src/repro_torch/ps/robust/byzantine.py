"""Byzantine worker models: seed-deterministic adversarial uplinks (port of
``repro.ps.robust.byzantine``).

A ``FaultPolicy`` (:mod:`repro_torch.ps.faults`) models workers that
*disappear*; a ``ByzantinePolicy`` models workers that stay in the round
and **lie**: they run their local steps honestly but corrupt the z̃
uplink before it leaves the worker. The engine applies the attack after
local compute and *before* compression, so it composes with the codecs and
error feedback exactly like an honest message would.

Membership is a pure function of ``(seed, num_workers, rounds)`` drawn
with numpy's ``default_rng``, so :meth:`ByzantinePolicy.attacked` gives
the JAX package's tables exactly. The *values* an attacker sends are
seed-deterministic too: stochastic attacks draw from the per-(round,
worker) keys the engine folds off the codec key chain.

``apply`` takes the port's payload, a tuple of worker-stacked ``(M, ...)``
leaves, an ``(M,)`` bool mask of this round's attackers and ``(M, 2)``
per-worker keys, and returns the corrupted tuple; honest lanes pass
through bit-unchanged.

* :class:`SignFlipAttack`    — send ``−scale · z̃``;
* :class:`ScaledNoiseAttack` — send ``z̃ + scale · 𝒩(0, I)``;
* :class:`ZeroAttack`        — send exact zeros;
* :class:`CollusionAttack`   — every attacker sends ``−eps ×`` the honest
  lanes' mean.

Examples
--------
>>> pol = SignFlipAttack(fraction=0.4, seed=3)
>>> t = pol.attacked(num_workers=5, rounds=3)
>>> t.shape, int(t[0].sum())
((3, 5), 2)
>>> import torch
>>> z = (torch.tensor([[1.0, -2.0], [3.0, 4.0]]),)
>>> SignFlipAttack(fraction=0.5, scale=2.0).apply(
...     z, torch.tensor([True, False]), None)[0].tolist()
[[-2.0, 4.0], [3.0, 4.0]]
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ... import random as jr
from ...core.tree import per_worker
from ...kernels.sync_compress.ref import f32


class ByzantinePolicy:
    """Protocol for Byzantine attack models: frozen dataclasses carrying
    ``fraction`` (of the fleet that is adversarial), ``seed`` (membership
    draw) and ``per_round`` (False: a fixed subset for the whole run; True:
    re-drawn each round). Subclasses implement :meth:`apply`."""

    fraction: float = 0.0
    seed: int = 0
    per_round: bool = False

    def count(self, num_workers: int) -> int:
        """Adversarial lanes per round: ``round(fraction · M)``, capped."""
        return min(num_workers, int(round(float(self.fraction)
                                          * num_workers)))

    def attacked(self, num_workers: int, rounds: int) -> np.ndarray:
        """Deterministic ``(rounds, num_workers)`` bool membership table."""
        out = np.zeros((rounds, num_workers), dtype=bool)
        n = self.count(num_workers)
        if n == 0:
            return out
        rng = np.random.default_rng(self.seed)
        if self.per_round:
            for r in range(rounds):
                out[r, rng.choice(num_workers, size=n, replace=False)] = True
        else:
            out[:, rng.choice(num_workers, size=n, replace=False)] = True
        return out

    def apply(self, payload, mask, rngs):
        """Corrupt the stacked uplink (see the module docstring)."""
        raise NotImplementedError

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def fingerprint(self) -> int:
        """crc32 of the canonical description."""
        return zlib.crc32(self.name.encode()) & 0xFFFFFFFF


def _mask(mask, like):
    return per_worker(torch.as_tensor(mask, device=like.device), like)


@dataclasses.dataclass(frozen=True)
class SignFlipAttack(ByzantinePolicy):
    """Attackers send ``−scale · z̃`` (``scale > 1`` also inflates)."""

    fraction: float
    scale: float = 1.0
    seed: int = 0
    per_round: bool = False

    @property
    def name(self) -> str:
        return (f"sign_flip(fraction={self.fraction},scale={self.scale},"
                f"seed={self.seed},per_round={self.per_round})")

    def apply(self, payload, mask, rngs):
        s = -f32(self.scale)
        return tuple(torch.where(_mask(mask, z), s * z, z) for z in payload)


@dataclasses.dataclass(frozen=True)
class ScaledNoiseAttack(ByzantinePolicy):
    """Attackers send ``z̃ + scale · 𝒩(0, I)``, the noise drawn per leaf
    from ``split(rngs[m], L)``, as the JAX package draws it."""

    fraction: float
    scale: float = 10.0
    seed: int = 0
    per_round: bool = False

    @property
    def name(self) -> str:
        return (f"scaled_noise(fraction={self.fraction},scale={self.scale},"
                f"seed={self.seed},per_round={self.per_round})")

    def apply(self, payload, mask, rngs):
        keys = jr.split(rngs, len(payload))                   # (M, L, 2)
        s = f32(self.scale)
        outs = []
        for li, z in enumerate(payload):
            noise = jr.normal(keys[:, li], z.shape[1:]).to(z.dtype)
            outs.append(torch.where(_mask(mask, z), z + s * noise, z))
        return tuple(outs)


@dataclasses.dataclass(frozen=True)
class ZeroAttack(ByzantinePolicy):
    """Attackers send exact zeros; unlike a crash their weight stays in
    the merge."""

    fraction: float
    seed: int = 0
    per_round: bool = False

    @property
    def name(self) -> str:
        return (f"zero(fraction={self.fraction},seed={self.seed},"
                f"per_round={self.per_round})")

    def apply(self, payload, mask, rngs):
        return tuple(torch.where(_mask(mask, z), 0.0, z) for z in payload)


@dataclasses.dataclass(frozen=True)
class CollusionAttack(ByzantinePolicy):
    """Every attacker sends the *same* vector, ``−eps ×`` the mean of the
    honest lanes' messages."""

    fraction: float
    eps: float = 1.0
    seed: int = 0
    per_round: bool = False

    @property
    def name(self) -> str:
        return (f"collusion(fraction={self.fraction},eps={self.eps},"
                f"seed={self.seed},per_round={self.per_round})")

    def apply(self, payload, mask, rngs):
        mv = torch.as_tensor(mask, device=payload[0].device)
        honest = (~mv).to(torch.float32)
        denom = torch.clamp(torch.sum(honest), min=1.0)
        s = -f32(self.eps)

        def one(z):
            # the honest rows summed in row order, as XLA reduces the
            # worker axis; a full-shape divisor, since PyTorch on the CPU
            # divides by a 0-d tensor as a multiplication by its reciprocal
            rows = per_worker(honest, z).to(z.dtype) * z
            total = rows[:1]
            for i in range(1, rows.shape[0]):
                total = total + rows[i:i + 1]
            hm = total / denom.to(z.dtype).expand(total.shape)
            return torch.where(per_worker(mv, z), (s * hm).expand(z.shape),
                               z)

        return tuple(one(z) for z in payload)
