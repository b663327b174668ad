"""The fault-tolerant training runtime (counterpart of
``deeplearning4j_tpu/resilience/``): atomic, versioned, write-behind
checkpoints with a sharded two-phase commit, scrub and repair
(``checkpoint.py``); retry with backoff and jitter (``retry.py``);
circuit breaking (``breaker.py``); deadlines (``deadline.py``); the
retrying object store (``store.py``); the divergence guard with its
skip and rollback policies (``guard.py``); preemption handling
(``preemption.py``); deterministic fault injection (``chaos.py``:
seeded failure schedules, the faulty store and iterators, the control
channel's drops, delays and partitions, and the SIGKILL at a step)."""

from deeplearning4j_tpu_torch.resilience.breaker import (  # noqa: F401
    CircuitBreaker,
)
from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosError,
    ChaosPolicy,
    ControlChannelChaos,
    FaultyObjectStore,
    FlakyIterator,
    KillAtStep,
    PoisonIterator,
)
from deeplearning4j_tpu_torch.resilience.checkpoint import (  # noqa: F401
    AsyncSaveHandle,
    CheckpointInfo,
    CheckpointListener,
    CheckpointManager,
    LeaseCommitBarrier,
    LocalCommitBarrier,
    ProcessGroupCommitBarrier,
    atomic_write_bytes,
    restore_into,
)
from deeplearning4j_tpu_torch.resilience.deadline import (  # noqa: F401
    Deadline,
)
from deeplearning4j_tpu_torch.resilience.guard import (  # noqa: F401
    DivergenceGuard,
    StatGuardConfig,
    apply_guard_state_doc,
    guard_state_doc,
)
from deeplearning4j_tpu_torch.resilience.preemption import (  # noqa: F401
    EXIT_PREEMPTED,
    EXIT_PREEMPTED_DIRTY,
    PreemptedException,
    PreemptionHandler,
    active_handler,
    exit_on_preemption,
    preemption_requested,
)
from deeplearning4j_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy,
    retry_call,
    retrying,
)
from deeplearning4j_tpu_torch.resilience.store import (  # noqa: F401
    RetryingObjectStore,
)
