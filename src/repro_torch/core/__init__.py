"""The DeltaBox checkpoint/rollback core, ported to PyTorch.

* :class:`~repro_torch.core.chunk_store.ChunkStore` — refcounted, dedupable
  base storage (blake2b chunk digests, identical to the JAX package's),
* :class:`~repro_torch.core.deltafs.DeltaFS` — shared refcounted overlay
  layers + per-sandbox namespace views (the durable dimension),
* :class:`~repro_torch.core.deltacr.DeltaCR` — template-fork fast restores +
  async delta dumps (the ephemeral dimension), over
  :class:`~repro_torch.core.deltacr.CowTensorState` device state or
  :class:`~repro_torch.core.deltacr.CowArrayState` host state,
* :class:`~repro_torch.core.state_manager.StateManager` — the coupled
  (filesystem, session state) checkpoint/restore protocol,
* :mod:`~repro_torch.core.convert` — state to and from numpy dicts,
* :mod:`~repro_torch.core.faults` — deterministic fault injection.

GC, the sandbox tree and the persistence plane are not ported yet.
"""
from .chunk_store import (
    ChunkCorruptionError,
    ChunkStore,
    ChunkStoreStats,
    RepairStats,
)
from .chunk_backend import (
    ChunkBackend,
    ColdBackend,
    DirObjectClient,
    TierManager,
    TierStats,
    WarmBackend,
    make_local_tiers,
    tier_key,
)
from .faults import FaultError, FaultPlan, FaultSpec, WorkerKilled
from .delta_pipeline import (
    ChunkedView,
    DeltaDumpPipeline,
    DeltaEncodable,
    DeltaGeneration,
    digest_encode_array,
    mark_clean,
    mark_unknown,
)
from .stream import (
    ChunkStreamEngine,
    DumpGate,
    StreamCancelled,
    StreamConfig,
    StreamStats,
)
from .deltafs import DeltaFS, LayerConfig, LayerStore, NamespaceView, TensorMeta
from .deltacr import (
    CowArrayState,
    CowTensorState,
    DeltaCR,
    DumpImage,
    DumpTimeout,
    ForkableState,
)
from .convert import state_from_numpy, state_to_numpy
from .policy import DumpPolicy, ModeSelector, dirty_fraction_hint
from .image_store import ImageRef, ImageStore, ImageStoreStats
from .npd import InferenceProxy, ProxyRequest
from .state_manager import CheckpointError, Sandbox, SnapshotNode, StateManager

__all__ = [
    "ChunkCorruptionError",
    "ChunkStore",
    "ChunkStoreStats",
    "RepairStats",
    "ChunkBackend",
    "ColdBackend",
    "DirObjectClient",
    "TierManager",
    "TierStats",
    "WarmBackend",
    "make_local_tiers",
    "tier_key",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "WorkerKilled",
    "ChunkedView",
    "DeltaDumpPipeline",
    "DeltaEncodable",
    "DeltaGeneration",
    "digest_encode_array",
    "mark_clean",
    "mark_unknown",
    "ChunkStreamEngine",
    "DumpGate",
    "StreamCancelled",
    "StreamConfig",
    "StreamStats",
    "DeltaFS",
    "LayerConfig",
    "LayerStore",
    "NamespaceView",
    "TensorMeta",
    "CowArrayState",
    "CowTensorState",
    "DeltaCR",
    "DumpImage",
    "DumpTimeout",
    "ForkableState",
    "state_from_numpy",
    "state_to_numpy",
    "DumpPolicy",
    "ModeSelector",
    "dirty_fraction_hint",
    "ImageRef",
    "ImageStore",
    "ImageStoreStats",
    "InferenceProxy",
    "ProxyRequest",
    "CheckpointError",
    "Sandbox",
    "SnapshotNode",
    "StateManager",
]
