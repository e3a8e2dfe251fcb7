"""MANA core: implementation-oblivious transparent checkpoint-restart.

The port's copy of the JAX package's ``repro.core``: the lower half (call
specs, interposition, virtual ids, backends, drain, faults), the checkpoint
container and pipeline, the restart plane, the runtime-state registry, and
the supervised recovery loop around them (``supervisor``: detect, classify,
restore, resume over the escalation ladder), its peer-replicated RAM tier
(``ckpt_tiers``) and live rescale (``elastic``)."""
from repro_torch.core.backends import BACKENDS, Fabric, backend_family, make_backend
from repro_torch.core.ckpt import CheckpointWriter
from repro_torch.core.ckpt_pipeline import HostArena, SnapshotPipeline, plan_snapshot
from repro_torch.core.ckpt_tiers import (ReplicaTier, TierImage, TierVerifyError,
                                         container_sha, ring_partner)
from repro_torch.core.coordinator import Cluster
from repro_torch.core.descriptors import Descriptor, Kind, Strategy
from repro_torch.core.drain import DrainStallError, drain_rank, drain_world
from repro_torch.core.elastic import (JoinTimeoutError, RescaleError, RescaleReport,
                                      join, shrink)
from repro_torch.core.faults import (FaultInjector, FaultPlan, FaultSpec,
                                     InjectedFault, RankDeadError, failpoint)
from repro_torch.core.interpose import Mana, handle_vid, make_handle
from repro_torch.core.restore import (PairPlan, find_resumable, load_arrays,
                                      rebind_objects, rebind_world, restart_matrix,
                                      translation_plan, verify_checkpoint)
from repro_torch.core.supervisor import (FAILURE_CLASSES, Incident, LeaseDetector,
                                         RecoveryFailed, Supervisor, SupervisorConfig,
                                         WorldFailure, classify_failure)
from repro_torch.core.vid import VidTable, compute_ggid, pack_vid, vid_index, vid_kind

__all__ = [
    "BACKENDS", "Fabric", "backend_family", "make_backend",
    "CheckpointWriter", "Cluster", "Descriptor", "Kind", "Strategy",
    "DrainStallError", "drain_rank", "drain_world", "FaultInjector",
    "FaultPlan", "FaultSpec", "InjectedFault", "RankDeadError", "failpoint",
    "HostArena", "SnapshotPipeline", "plan_snapshot", "Mana", "handle_vid",
    "make_handle", "PairPlan", "find_resumable", "load_arrays",
    "rebind_objects", "rebind_world", "restart_matrix", "translation_plan",
    "verify_checkpoint", "ReplicaTier", "TierImage", "TierVerifyError",
    "container_sha", "ring_partner", "JoinTimeoutError", "RescaleError",
    "RescaleReport", "join", "shrink", "FAILURE_CLASSES", "Incident",
    "LeaseDetector", "RecoveryFailed", "Supervisor", "SupervisorConfig",
    "WorldFailure", "classify_failure", "VidTable", "compute_ggid", "pack_vid",
    "vid_index", "vid_kind",
]
