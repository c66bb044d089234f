"""Parameter-Server runtime, serial path: Algorithm 1 with the built-in
codecs (identity, stochastic quantization and top-k, with error feedback),
schedules and fault policies, hostile fleets (Byzantine attacks, DP
uplinks, robust merges), the server-side outer optimizer, checkpoints, and
Dirichlet-heterogeneous workers (``partition``), and the event-driven
asynchronous engine over simulated time (``AsyncPSEngine`` with the
``latency`` models), and sampled-client rounds in both engines
(``ClientSampler``). The sharded path is ported in a later slice."""
from ..core.adaseg import AdaSEGConfig
from ..core.worker import AdaSEGWorker, LocalWorker
from .async_engine import AsyncPSConfig, AsyncPSEngine
from .compress import (
    IdentityCompressor,
    StochasticQuantizeCompressor,
    SyncCompressor,
    TopKCompressor,
    check_codec_backend,
    dense_bytes,
)
from .engine import (
    PSConfig,
    PSEngine,
    RobustPipeline,
    make_sampled_chunk,
    make_serial_chunk,
    make_sync_stacked,
    resolve_robust,
)
from .faults import BernoulliFaults, FaultPolicy, NoFaults, OutageFaults
from .latency import (
    ConstantLatency,
    LatencyModel,
    LatencyTables,
    LognormalLatency,
    MarkovLatency,
    TraceLatency,
)
from .partition import (
    heterogeneous_bilinear,
    heterogeneous_robust,
    heterogeneous_wgan,
    heterogenize,
    mixture_sampler,
)
from .robust import (
    ByzantinePolicy,
    CollusionAttack,
    CoordinateMedian,
    DPUplink,
    MultiKrum,
    RobustAggregator,
    ScaledNoiseAttack,
    SignFlipAttack,
    TrimmedMean,
    WeightedMean,
    ZeroAttack,
)
from .sampler import ClientSampler
from .schedule import (
    ElasticSchedule,
    FixedSchedule,
    StragglerSchedule,
    UniformSchedule,
    WorkerSchedule,
)
from .server_opt import (
    NoServerOpt,
    ServerAdam,
    ServerMomentum,
    ServerNesterov,
    ServerOptimizer,
    resolve_server_opt,
)
from .trace import RoundRecord, TraceRecorder

__all__ = [
    "AdaSEGConfig",
    "AdaSEGWorker",
    "AsyncPSConfig",
    "AsyncPSEngine",
    "BernoulliFaults",
    "ByzantinePolicy",
    "ClientSampler",
    "CollusionAttack",
    "ConstantLatency",
    "CoordinateMedian",
    "DPUplink",
    "ElasticSchedule",
    "FaultPolicy",
    "FixedSchedule",
    "IdentityCompressor",
    "LatencyModel",
    "LatencyTables",
    "LocalWorker",
    "LognormalLatency",
    "MarkovLatency",
    "MultiKrum",
    "NoFaults",
    "NoServerOpt",
    "OutageFaults",
    "PSConfig",
    "PSEngine",
    "RobustAggregator",
    "RobustPipeline",
    "RoundRecord",
    "ScaledNoiseAttack",
    "ServerAdam",
    "ServerMomentum",
    "ServerNesterov",
    "ServerOptimizer",
    "SignFlipAttack",
    "StochasticQuantizeCompressor",
    "StragglerSchedule",
    "SyncCompressor",
    "TopKCompressor",
    "TraceLatency",
    "TraceRecorder",
    "TrimmedMean",
    "UniformSchedule",
    "WeightedMean",
    "WorkerSchedule",
    "ZeroAttack",
    "check_codec_backend",
    "dense_bytes",
    "heterogeneous_bilinear",
    "heterogeneous_robust",
    "heterogeneous_wgan",
    "heterogenize",
    "make_sampled_chunk",
    "make_serial_chunk",
    "make_sync_stacked",
    "mixture_sampler",
    "resolve_robust",
    "resolve_server_opt",
]
