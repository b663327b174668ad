"""Crash-safe promotion journal.

Counterpart of ``deeplearning4j_tpu/loop/journal.py``: the same
document, keys and values, so a journal one package wrote is read by
the other.

The promoter's state machine (``promoter.py``) survives a SIGKILL at
any instant because every transition is journaled to ONE on-disk JSON
document *before* its side effects become visible, and the document is
replaced atomically (temp file + ``os.replace`` — the same primitive
the checkpoint manifests use). A recovering promoter reads the journal
and either rolls the half-applied transition forward or back; there is
no state the journal can describe that recovery cannot resolve.

Document (format 1)::

    {"format": 1,
     "state": "idle|candidate|shadowing|canarying|promoted|rolled_back"
              "|quarantined",
     "candidate_step": 12,       # the version under evaluation
     "previous_step": 8,         # what was serving when it appeared
     "promoted_step": 8,         # last FULLY promoted version
     "probation": false,         # promoted but still watched
     "gates_passed": true,       # shadow gates verdict (pre-canary)
     "reason": "...",            # why the last terminal state
     "rejected_steps": [...],    # candidates that failed gates/canary
     "quarantined_steps": [...], # candidates whose checkpoint was bad
     "history": [... last 32 transitions ...]}

``referenced_steps()`` is the retention contract: the checkpoint
manager must never prune the steps the journal still points at
(``CheckpointManager(protect=journal.referenced_steps)``), or a
recovery could find its rollback target deleted.

A journal that is missing reads as empty (fresh install). A journal
that is unreadable (torn by external tampering — atomic replace never
produces one) reads as empty too, with a warning: the promoter then
re-derives a consistent state from what the server actually serves,
which is always safe, merely forgetful.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import List, Optional

from deeplearning4j_tpu_torch.resilience.checkpoint import (
    atomic_write_bytes,
)

logger = logging.getLogger(__name__)

JOURNAL_FORMAT = 1
HISTORY_LIMIT = 32

# the promoter's state machine, as journaled
IDLE = "idle"
CANDIDATE = "candidate"
SHADOWING = "shadowing"
CANARYING = "canarying"
PROMOTED = "promoted"
ROLLED_BACK = "rolled_back"
QUARANTINED = "quarantined"

STATES = (IDLE, CANDIDATE, SHADOWING, CANARYING, PROMOTED,
          ROLLED_BACK, QUARANTINED)

# gauge encoding for ``loop_state`` (stable; dashboards key on it)
STATE_CODES = {s: i for i, s in enumerate(STATES)}


class PromotionJournal:
    """One atomic JSON document recording the promotion state machine.

    Reads are tolerant (missing/torn -> empty doc); writes are atomic
    and carry a bounded transition history for post-mortems.
    """

    def __init__(self, path):
        self.path = Path(path)

    # -- read -----------------------------------------------------------

    def read(self) -> dict:
        """The current document, or a fresh empty one when the file is
        missing or unreadable (never raises)."""
        try:
            doc = json.loads(self.path.read_text())
            if not isinstance(doc, dict):
                raise ValueError("journal root is not an object")
        except FileNotFoundError:
            return self._empty()
        except (ValueError, OSError) as e:
            logger.warning(
                "promotion journal %s is unreadable (%s); treating as "
                "empty — recovery re-derives state from the server",
                self.path, e,
            )
            return self._empty()
        base = self._empty()
        base.update(doc)
        return base

    @staticmethod
    def _empty() -> dict:
        return {
            "format": JOURNAL_FORMAT,
            "state": IDLE,
            "candidate_step": None,
            "previous_step": None,
            "promoted_step": None,
            "probation": False,
            "gates_passed": False,
            "reason": None,
            "rejected_steps": [],
            "quarantined_steps": [],
            "history": [],
        }

    @property
    def state(self) -> str:
        return self.read().get("state", IDLE)

    # -- write ----------------------------------------------------------

    def write(self, state: str, **fields) -> dict:
        """Record one transition: merge ``fields`` into the document,
        set ``state``, append to history, and replace the file
        atomically. Returns the new document."""
        if state not in STATES:
            raise ValueError(f"unknown journal state {state!r}")
        doc = self.read()
        doc["state"] = state
        for k, v in fields.items():
            if k in ("rejected_steps", "quarantined_steps"):
                # list fields merge (append-once), never overwrite
                merged = list(doc.get(k) or [])
                for step in (v if isinstance(v, (list, tuple)) else [v]):
                    if step is not None and step not in merged:
                        merged.append(step)
                doc[k] = merged
            else:
                doc[k] = v
        entry = {"state": state, "at": time.time()}
        for k in ("candidate_step", "previous_step", "promoted_step",
                  "probation", "reason"):
            if doc.get(k) is not None:
                entry[k] = doc[k]
        doc["history"] = (doc.get("history") or [])[-(HISTORY_LIMIT - 1):]
        doc["history"].append(entry)
        atomic_write_bytes(
            self.path, json.dumps(doc, indent=2).encode()
        )
        return doc

    # -- retention contract ---------------------------------------------

    def referenced_steps(self) -> List[int]:
        """Checkpoint steps the journal still points at — the steps
        retention pruning must never delete (candidate under
        evaluation, the serving previous version, the last promoted
        version). Wire as ``CheckpointManager(protect=
        journal.referenced_steps)``."""
        doc = self.read()
        out = []
        for k in ("candidate_step", "previous_step", "promoted_step"):
            v = doc.get(k)
            if isinstance(v, int) and v not in out:
                out.append(v)
        return out

    def skip_steps(self) -> List[int]:
        """Candidate steps already judged (rejected or quarantined) —
        the promoter must not re-shadow them on every poll."""
        doc = self.read()
        out = []
        for k in ("rejected_steps", "quarantined_steps"):
            for v in doc.get(k) or []:
                if isinstance(v, int) and v not in out:
                    out.append(v)
        return out


class SimulatedKill(RuntimeError):
    """Raised by the promoter's chaos hook (``fail_after_journal``) to
    model a SIGKILL landing right after a journal write — the worst
    instant, because the journal now leads the world. Tests and
    ``chip_smoke.py``'s ``[loop]`` catch it and prove recovery
    converges."""


def state_code(state: Optional[str]) -> int:
    return STATE_CODES.get(state or IDLE, 0)
