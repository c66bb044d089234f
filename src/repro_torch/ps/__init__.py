"""Parameter-Server runtime, serial path: Algorithm 1 with the built-in
codecs (identity, stochastic quantization and top-k, with error feedback),
schedules and fault policies. The rest of the JAX package's runtime is
ported in later slices."""
from ..core.adaseg import AdaSEGConfig
from ..core.worker import AdaSEGWorker, LocalWorker
from .compress import (
    IdentityCompressor,
    StochasticQuantizeCompressor,
    SyncCompressor,
    TopKCompressor,
    check_codec_backend,
    dense_bytes,
)
from .engine import PSConfig, PSEngine, make_serial_chunk, make_sync_stacked
from .faults import BernoulliFaults, FaultPolicy, NoFaults, OutageFaults
from .schedule import (
    ElasticSchedule,
    FixedSchedule,
    StragglerSchedule,
    UniformSchedule,
    WorkerSchedule,
)
from .trace import RoundRecord, TraceRecorder

__all__ = [
    "AdaSEGConfig",
    "AdaSEGWorker",
    "BernoulliFaults",
    "ElasticSchedule",
    "FaultPolicy",
    "FixedSchedule",
    "IdentityCompressor",
    "LocalWorker",
    "NoFaults",
    "OutageFaults",
    "PSConfig",
    "PSEngine",
    "RoundRecord",
    "StochasticQuantizeCompressor",
    "StragglerSchedule",
    "SyncCompressor",
    "TopKCompressor",
    "TraceRecorder",
    "UniformSchedule",
    "WorkerSchedule",
    "check_codec_backend",
    "dense_bytes",
    "make_serial_chunk",
    "make_sync_stacked",
]
