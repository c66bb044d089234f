"""ModelWorker: a real architecture as a LocalWorker on the PS runtime
(port of ``repro.models.worker``).

Its state is the model's parameter tree (as the AdaSEG anchor and explore
iterates) plus the adaptive-η accumulators; its step is one extragradient
model train step, two gradient calls of the model's loss. It subclasses
:class:`~repro_torch.core.worker.AdaSEGWorker`, so the engine's schedules,
codecs, faults, hostile fleets and checkpoints apply to models unchanged.
The only addition is ``arch``: it is part of :attr:`name` and so of the
CRC32 :attr:`fingerprint`, and restoring a checkpoint into an engine built
for another architecture is refused like a wrong seed.

Examples
--------
>>> from repro_torch.core import AdaSEGConfig
>>> a = ModelWorker(AdaSEGConfig(g0=5.0, diameter=1.0, k=2), arch="tiny-lm")
>>> b = ModelWorker(AdaSEGConfig(g0=5.0, diameter=1.0, k=2), arch="wgan_gp")
>>> a.name
'model[tiny-lm]+adaseg(g0=5.0,D=1.0,alpha=1.0,avg=True)'
>>> a.fingerprint != b.fingerprint
True
"""
from __future__ import annotations

import dataclasses

from ..core.worker import AdaSEGWorker

__all__ = ["ModelWorker"]


@dataclasses.dataclass(frozen=True)
class ModelWorker(AdaSEGWorker):
    """LocalAdaSEG over a real model's parameters. ``arch`` names the
    architecture and is hashed into :attr:`fingerprint`; ``backend``
    selects the AdaSEG step implementation as for any AdaSEG worker (the
    fused kernels take the model's leaves: its projection is the
    identity)."""

    arch: str = "model"

    @property
    def name(self) -> str:
        c = self.cfg
        return (f"model[{self.arch}]+adaseg(g0={c.g0},D={c.diameter},"
                f"alpha={c.alpha},avg={c.average_output})")
