"""Parameter-Server runtime, serial path (Algorithm 1 with the identity
codec, a uniform schedule and no faults; the rest of the JAX package's
runtime is ported in later slices)."""
from ..core.adaseg import AdaSEGConfig
from ..core.worker import AdaSEGWorker, LocalWorker
from .compress import IdentityCompressor, SyncCompressor, dense_bytes
from .engine import PSConfig, PSEngine, make_serial_chunk, make_sync_stacked
from .faults import FaultPolicy, NoFaults
from .schedule import UniformSchedule, WorkerSchedule
from .trace import RoundRecord, TraceRecorder

__all__ = [
    "AdaSEGConfig",
    "AdaSEGWorker",
    "FaultPolicy",
    "IdentityCompressor",
    "LocalWorker",
    "NoFaults",
    "PSConfig",
    "PSEngine",
    "RoundRecord",
    "SyncCompressor",
    "TraceRecorder",
    "UniformSchedule",
    "WorkerSchedule",
    "dense_bytes",
    "make_serial_chunk",
    "make_sync_stacked",
]
