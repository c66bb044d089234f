"""Server-side *outer* optimizers, the DiLoCo/FedOpt two-level scheme
(port of ``repro.ps.server_opt``).

The paper's server merge (Algorithm 1, Line 7) replaces every worker's
anchor with the 1/η-weighted average of the fleet's local iterates. The
two-level view treats the per-round movement of that merge as a
*pseudo-gradient*,

    Δ_r = merge(z̃_1..M) − z_server ,

and runs a small stateful optimizer over it on the server: the broadcast
anchor becomes ``z_server ← z_server + lr · update(Δ_r)`` instead of the
raw merge. With ``lr = 1`` and no momentum this IS Line 7, which is why
the ``none`` policy resolves to the historical code path bit-exactly.

Each policy has a stable ``name`` (hyperparameters folded in), a crc32
``fingerprint`` (checkpointed as ``server_opt_fp``) and a static ``spec``
tuple that the CUDA kernel and its plain version
(``kernels.sync_compress.ops.server_outer_apply``) switch on:

* ``("momentum", lr, β)``       — m′ = β·m + Δ;  z′ = z + lr·m′
* ``("nesterov", lr, β)``       — m′ = β·m + Δ;  z′ = z + lr·(Δ + β·m′)
* ``("adam", lr, β₁, β₂, ε)``   — bias-corrected Adam over Δ (t counts
  server rounds, not worker steps)

The outer step runs downstream of robust aggregation and upstream of
delivery gating (workers that miss the broadcast keep their stale anchor).

Examples
--------
>>> from repro_torch.ps.server_opt import (NoServerOpt, ServerAdam,
...                                        ServerMomentum, ServerNesterov)
>>> ServerNesterov(lr=0.7, beta=0.9).spec
('nesterov', 0.7, 0.9)
>>> opts = [ServerMomentum(), ServerNesterov(), ServerAdam()]
>>> len({o.fingerprint for o in opts}) == 3
True
>>> NoServerOpt().spec is None
True
"""
from __future__ import annotations

import dataclasses
import zlib

import torch


class ServerOptimizer:
    """Base protocol: a server-side optimizer over round deltas.

    Subclasses define ``name`` (hyperparameters folded in — it feeds the
    checkpoint fingerprint) and ``spec`` (the static tuple the kernel
    switches on; ``None`` means *no outer step*, the historical
    Line-7 path). ``slots`` is the number of z-shaped moment trees the
    policy carries (0 for none, 1 for momentum/nesterov, 2 for adam).

    Examples
    --------
    >>> from repro_torch.ps import (NoServerOpt, ServerAdam,
    ...                             ServerMomentum, ServerNesterov)
    >>> ServerMomentum(lr=0.5, beta=0.8).spec
    ('momentum', 0.5, 0.8)
    >>> ServerNesterov().spec                 # DiLoCo's outer optimizer
    ('nesterov', 1.0, 0.9)
    >>> ServerAdam().spec                     # FedOpt's FedAdam shape
    ('adam', 1.0, 0.9, 0.99, 1e-08)
    >>> (NoServerOpt().slots, ServerNesterov().slots, ServerAdam().slots)
    (0, 1, 2)
    >>> import torch
    >>> mom = ServerAdam().init_moments((torch.ones(1, 3),))
    >>> len(mom), float(mom[0][0].sum())
    (2, 0.0)
    """

    slots = 0

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def spec(self):
        """Static math spec consumed by ``server_outer_apply`` — or None
        for the identity (historical) server."""
        return None

    @property
    def fingerprint(self) -> int:
        """crc32 of the policy name — serialized as ``server_opt_fp`` so
        restores under a different outer optimizer (or different
        hyperparameters) are rejected."""
        return zlib.crc32(self.name.encode()) & 0xFFFFFFFF

    def init_moments(self, z):
        """Zero moment trees (tuples of tensors) shaped like the server
        anchor ``z``."""
        return tuple(tuple(torch.zeros_like(v) for v in z)
                     for _ in range(self.slots))


@dataclasses.dataclass(frozen=True)
class NoServerOpt(ServerOptimizer):
    """Explicit historical server: broadcast the merge as-is (Line 7).

    Resolves to the same code path as ``server_opt=None``, bit for bit,
    including the checkpoint layout (no ``server_opt_fp``).
    """

    @property
    def name(self) -> str:
        return "none"


@dataclasses.dataclass(frozen=True)
class ServerMomentum(ServerOptimizer):
    """Heavy-ball over round deltas: m′ = β·m + Δ, z′ = z + lr·m′."""

    lr: float = 1.0
    beta: float = 0.9
    slots = 1

    def __post_init__(self):
        if not (self.lr > 0):
            raise ValueError(f"lr must be positive, got {self.lr}")
        if not (0.0 <= self.beta < 1.0):
            raise ValueError(f"beta must be in [0, 1), got {self.beta}")

    @property
    def name(self) -> str:
        return f"momentum[lr={self.lr:g},beta={self.beta:g}]"

    @property
    def spec(self):
        return ("momentum", float(self.lr), float(self.beta))


@dataclasses.dataclass(frozen=True)
class ServerNesterov(ServerOptimizer):
    """Nesterov over round deltas — the DiLoCo outer optimizer:
    m′ = β·m + Δ, z′ = z + lr·(Δ + β·m′)."""

    lr: float = 1.0
    beta: float = 0.9
    slots = 1

    def __post_init__(self):
        if not (self.lr > 0):
            raise ValueError(f"lr must be positive, got {self.lr}")
        if not (0.0 <= self.beta < 1.0):
            raise ValueError(f"beta must be in [0, 1), got {self.beta}")

    @property
    def name(self) -> str:
        return f"nesterov[lr={self.lr:g},beta={self.beta:g}]"

    @property
    def spec(self):
        return ("nesterov", float(self.lr), float(self.beta))


@dataclasses.dataclass(frozen=True)
class ServerAdam(ServerOptimizer):
    """Bias-corrected Adam over round deltas (FedOpt's FedAdam shape);
    ``t`` counts server rounds, so the bias correction warms up over the
    first few syncs exactly like step-indexed Adam."""

    lr: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    slots = 2

    def __post_init__(self):
        if not (self.lr > 0):
            raise ValueError(f"lr must be positive, got {self.lr}")
        for nm, b in (("beta1", self.beta1), ("beta2", self.beta2)):
            if not (0.0 <= b < 1.0):
                raise ValueError(f"{nm} must be in [0, 1), got {b}")
        if not (self.eps > 0):
            raise ValueError(f"eps must be positive, got {self.eps}")

    @property
    def name(self) -> str:
        return (f"adam[lr={self.lr:g},b1={self.beta1:g},"
                f"b2={self.beta2:g},eps={self.eps:g}]")

    @property
    def spec(self):
        return ("adam", float(self.lr), float(self.beta1),
                float(self.beta2), float(self.eps))


def resolve_server_opt(config):
    """The engine-side resolution: ``None`` for the historical path.

    ``server_opt=None`` and an explicit :class:`NoServerOpt` both resolve
    to ``None``: the engine then builds the *identical* merge closure and
    keeps the historical checkpoint layout byte-identical, mirroring
    ``resolve_robust``.

    Examples
    --------
    >>> from repro_torch.ps.server_opt import (
    ...     NoServerOpt, ServerNesterov, resolve_server_opt)
    >>> class Cfg: server_opt = None
    >>> resolve_server_opt(Cfg()) is None
    True
    >>> Cfg.server_opt = NoServerOpt()
    >>> resolve_server_opt(Cfg()) is None     # explicit none also resolves
    True
    >>> Cfg.server_opt = ServerNesterov()
    >>> resolve_server_opt(Cfg()).name
    'nesterov[lr=1,beta=0.9]'
    """
    so = getattr(config, "server_opt", None)
    if so is None or so.spec is None:
        return None
    return so
