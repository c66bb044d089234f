"""Hostile-fleet subsystem (port of ``repro.ps.robust``): Byzantine
attacks, robust aggregation, DP uplinks.

Three composable layers around the honest Parameter-Server round, in wire
order::

    local steps → [attack] → [DP clip+noise] → codec/EF → robust merge

Selected via ``PSConfig(byzantine=…, aggregator=…, dp=…)``. With any layer
active the engine switches the uplink to the *unweighted* wire format and
applies the Line-7 weights server-side, so order statistics rank workers'
iterates rather than their weighted messages; at zero robustness budget
(no attack, ``spec(m) is None``, no DP) the engine runs the historical
path, bit for bit.
"""
from .aggregators import (
    CoordinateMedian,
    MultiKrum,
    RobustAggregator,
    TrimmedMean,
    WeightedMean,
)
from .byzantine import (
    ByzantinePolicy,
    CollusionAttack,
    ScaledNoiseAttack,
    SignFlipAttack,
    ZeroAttack,
)
from .dp import DPUplink

__all__ = [
    "ByzantinePolicy",
    "SignFlipAttack",
    "ScaledNoiseAttack",
    "ZeroAttack",
    "CollusionAttack",
    "RobustAggregator",
    "WeightedMean",
    "TrimmedMean",
    "CoordinateMedian",
    "MultiKrum",
    "DPUplink",
]
