"""The continuous-learning loop: train → checkpoint → shadow →
canary → promote, with crash-safe promotion and auto-rollback.

Every piece existed — ``CheckpointManager`` (atomic versioned
checkpoints + AOT bundles), the serving tier's canary-validated hot
reload and immutable version snapshots, the breaker, the metrics
registry, the prefetching trainer — but nothing closed the loop, and
nothing could *undo* a bad model once it took traffic. This package
closes it:

- ``trainer.py`` — ``ContinualTrainer``: fit a streaming iterator
  incrementally, publish a versioned checkpoint (AOT bundle
  attached) every N steps, resume bitwise from a mid-epoch kill;
- ``shadow.py`` — ``ShadowScorer``: mirror a seeded fraction of live
  traffic to a candidate over the same padded bucketed path, results
  never returned to clients; accumulate agreement / latency-delta /
  health evidence;
- ``promoter.py`` — ``Promoter`` + ``PromotionGates``: the
  candidate → shadowing → canarying → promoted | rolled_back state
  machine, every transition journaled before its side effects;
  rollback re-installs the previous version's retained snapshot with
  zero new shapes and zero dropped in-flight requests;
- ``journal.py`` — ``PromotionJournal``: one atomic on-disk JSON
  document; a SIGKILLed promoter resumes exactly where it died, and
  a half-applied promotion is always rolled forward or back — never
  left split. The journal's referenced steps are retention-protected
  in the checkpoint store.

Counterpart of ``deeplearning4j_tpu/loop/``. On the card,
``chip_smoke.py``'s ``[loop]`` drives LeNet-5 through publish → shadow
→ promote → rollback under live HTTP traffic; on the CPU,
``tests/test_torch_loop.py`` holds each piece against the JAX package.
"""

from deeplearning4j_tpu_torch.loop.journal import (  # noqa: F401
    CANARYING,
    IDLE,
    PROMOTED,
    PromotionJournal,
    QUARANTINED,
    ROLLED_BACK,
    SHADOWING,
    SimulatedKill,
    STATE_CODES,
)
from deeplearning4j_tpu_torch.loop.promoter import (  # noqa: F401
    Promoter,
    PromotionGates,
)
from deeplearning4j_tpu_torch.loop.shadow import (  # noqa: F401
    ShadowScorer,
    agreement_rows,
)
from deeplearning4j_tpu_torch.loop.trainer import (  # noqa: F401
    ContinualTrainer,
)
