"""Stats records and the storage SPI (reference
``deeplearning4j-ui-model``: ``StatsListener.java:46`` record content,
``api/storage/StatsStorage``/``Persistable``/``StorageMetaData``/
``StatsStorageRouter`` SPI in ``deeplearning4j-core``).

Counterpart of ``deeplearning4j_tpu/ui/model.py``, kept as its own
copy. The reference encodes records with generated SBE codecs
(``ui/stats/sbe/UpdateEncoder.java``); here records are plain
dataclasses with a stable JSON wire encoding, byte for byte the JAX
package's (``encode``: ``json.dumps`` of the fields plus
``record_type``), so a ``FileStatsStorage`` file or a
``/remoteReceive`` post written by either package decodes in the
other."""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class StatsInitializationReport:
    """Once-per-session static info (reference
    ``SbeStatsInitializationReport``): software/hardware/model info."""

    session_id: str
    worker_id: str
    timestamp: float
    software: Dict[str, str] = field(default_factory=dict)
    hardware: Dict[str, str] = field(default_factory=dict)
    model: Dict[str, str] = field(default_factory=dict)

    record_type = "init"

    def encode(self) -> bytes:
        d = asdict(self)
        d["record_type"] = self.record_type
        return json.dumps(d).encode()


@dataclass
class StatsReport:
    """Per-iteration update (reference ``SbeStatsReport`` content per
    ``StatsListener.iterationDone:259``): score, timing, memory,
    per-param histograms/mean-magnitudes/learning rates."""

    session_id: str
    worker_id: str
    timestamp: float
    iteration: int
    score: float
    duration_ms: float = 0.0
    memory: Dict[str, float] = field(default_factory=dict)
    learning_rates: Dict[str, float] = field(default_factory=dict)
    param_mean_magnitudes: Dict[str, float] = field(default_factory=dict)
    update_mean_magnitudes: Dict[str, float] = field(default_factory=dict)
    param_histograms: Dict[str, dict] = field(default_factory=dict)
    activation_mean_magnitudes: Dict[str, float] = field(
        default_factory=dict)
    minibatches_per_second: float = float("nan")
    examples_per_second: float = float("nan")

    record_type = "update"

    def encode(self) -> bytes:
        d = asdict(self)
        d["record_type"] = self.record_type
        return json.dumps(d).encode()


def decode_record(data: bytes):
    d = json.loads(data.decode())
    rt = d.pop("record_type", "update")
    cls = StatsInitializationReport if rt == "init" else StatsReport
    return cls(**d)


class StatsStorage:
    """Storage SPI (reference ``api/storage/StatsStorage.java``):
    session → worker → records, with attachable listeners that fire on
    new records (the Play UI modules subscribe this way)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._static: Dict[str, Dict[str, StatsInitializationReport]] = {}
        self._updates: Dict[str, Dict[str, List[StatsReport]]] = {}
        self._listeners: List[Callable] = []

    # -- router side ----------------------------------------------------

    def put_static_info(self, rec: StatsInitializationReport) -> None:
        with self._lock:
            self._static.setdefault(rec.session_id, {})[rec.worker_id] = rec
        self._notify("static", rec)

    def put_update(self, rec: StatsReport) -> None:
        with self._lock:
            self._updates.setdefault(rec.session_id, {}).setdefault(
                rec.worker_id, []
            ).append(rec)
        self._notify("update", rec)

    # -- query side -----------------------------------------------------

    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def list_workers(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted(
                set(self._static.get(session_id, {}))
                | set(self._updates.get(session_id, {}))
            )

    def get_static_info(self, session_id: str,
                        worker_id: str) -> Optional[
                            StatsInitializationReport]:
        with self._lock:
            return self._static.get(session_id, {}).get(worker_id)

    def get_all_updates(self, session_id: str,
                        worker_id: str) -> List[StatsReport]:
        with self._lock:
            return list(
                self._updates.get(session_id, {}).get(worker_id, [])
            )

    def get_latest_update(self, session_id: str,
                          worker_id: str) -> Optional[StatsReport]:
        ups = self.get_all_updates(session_id, worker_id)
        return ups[-1] if ups else None

    # -- events ---------------------------------------------------------

    def register_stats_storage_listener(self, fn: Callable) -> None:
        self._listeners.append(fn)

    def _notify(self, kind: str, rec) -> None:
        for fn in list(self._listeners):
            try:
                fn(kind, rec)
            except Exception:  # listener bugs must not kill training
                pass

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """Reference ``InMemoryStatsStorage`` — the base class is already
    in-memory."""


class FileStatsStorage(StatsStorage):
    """Append-only JSONL file persistence (reference
    ``FileStatsStorage`` / ``MapDBStatsStorage`` file mode). Existing
    records are loaded on open; new records appended."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        self._file_lock = threading.Lock()
        try:
            with open(path, "rb") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = decode_record(line)
                    if isinstance(rec, StatsInitializationReport):
                        super().put_static_info(rec)
                    else:
                        super().put_update(rec)
        except FileNotFoundError:
            pass

    def _append(self, rec) -> None:
        with self._file_lock:
            with open(self._path, "ab") as f:
                f.write(rec.encode() + b"\n")

    def put_static_info(self, rec: StatsInitializationReport) -> None:
        self._append(rec)
        super().put_static_info(rec)

    def put_update(self, rec: StatsReport) -> None:
        self._append(rec)
        super().put_update(rec)


def now_ms() -> float:
    return time.time() * 1000.0
