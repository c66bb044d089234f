"""The card the port runs on, by its published rates.

NVIDIA H100 SXM5 80GB HBM3 (NVIDIA's data sheet). Where the JAX package's
roofline constants describe a TPU (``repro.roofline.analysis``), these
describe the card; the port's roofline tooling (ROADMAP A21) takes them
over.

>>> HBM_BW / 1e12
3.35
"""

#: device-memory (HBM3) bandwidth, bytes per second
HBM_BW = 3.35e12
