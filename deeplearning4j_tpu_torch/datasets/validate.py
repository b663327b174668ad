"""The validating and quarantining input pipeline (data-plane
defense).

Counterpart of ``deeplearning4j_tpu/datasets/validate.py``, with the
same reason codes, schema inference, manifest and blob format, so each
package reads the other's quarantine store:

- :class:`BatchSchema`: what a good minibatch looks like (trailing
  feature and label widths, dtype kinds, the label range, a magnitude
  ceiling), given or inferred from a model (``from_model``);
- :class:`BatchValidator`: the violated reason codes of one batch
  (empty: clean), checked on the host array before any placement; a
  batch that already is a tensor costs one reduction and one readback
  a check;
- :class:`QuarantineStore`: rejected batches as atomic npz blobs plus
  a JSON manifest (reason, stream offset, CRC-32, size), oldest-first
  eviction past ``max_bytes``, and ``replay()``;
- :class:`ValidatingIterator`: a ``DataSetIterator`` decorator that
  quarantines each offender and yields the next good batch, recording
  the stream offset of every reject, so a defended run trains on
  exactly the surviving batches: bitwise the clean run over them.

Wiring: ``PrefetchIterator(validator=...)`` checks on the prefetch
worker; ``DistributedTrainer.fit(validator=...)`` and the engines'
``set_batch_validator`` wrap their iterator. Metrics (the JAX
package's names): ``batches_quarantined_total{reason}`` and
``quarantine_bytes``.
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

logger = logging.getLogger(__name__)

# reason codes, one per check (stable strings: they label the
# batches_quarantined_total counter and the quarantine manifest)
REASON_SHAPE = "shape"
REASON_DTYPE = "dtype"
REASON_NON_FINITE = "non_finite"
REASON_LABEL_RANGE = "label_range"
REASON_MASK_MISMATCH = "mask_mismatch"
REASON_MAGNITUDE = "magnitude"

ALL_REASONS = (
    REASON_SHAPE, REASON_DTYPE, REASON_NON_FINITE,
    REASON_LABEL_RANGE, REASON_MASK_MISMATCH, REASON_MAGNITUDE,
)

_QUARANTINE_METRICS = None


def _quarantine_metrics():
    global _QUARANTINE_METRICS
    if _QUARANTINE_METRICS is None:
        from deeplearning4j_tpu_torch.observability.metrics import (
            default_registry,
        )

        reg = default_registry()
        _QUARANTINE_METRICS = (
            reg.counter(
                "batches_quarantined_total", labels=("reason",),
                help="input batches rejected by the validator, by "
                     "first violated reason code",
            ),
            reg.gauge(
                "quarantine_bytes",
                help="bytes currently held in the quarantine store",
            )._default(),
        )
    return _QUARANTINE_METRICS


@dataclass(frozen=True)
class BatchSchema:
    """What a clean minibatch looks like. All fields optional — a
    ``None`` disables that check:

    - ``feature_dim`` / ``label_dim``: expected TRAILING dim of
      features/labels (batch and, for sequences, time axes are free);
    - ``feature_dtype_kinds`` / ``label_dtype_kinds``: allowed numpy
      dtype kinds (default floats + ints — object/str payloads are
      the classic corrupt-CSV symptom);
    - ``label_range``: inclusive (lo, hi) every label must fall in
      (one-hot / probability targets: (0, 1));
    - ``max_abs``: magnitude ceiling for *finite* feature values —
      the finite-but-huge poison a NaN guard never sees.
    """

    feature_dim: Optional[int] = None
    label_dim: Optional[int] = None
    feature_dtype_kinds: Tuple[str, ...] = ("f", "i", "u")
    label_dtype_kinds: Tuple[str, ...] = ("f", "i", "u")
    label_range: Optional[Tuple[float, float]] = None
    max_abs: Optional[float] = None

    @classmethod
    def from_model(cls, model, *, max_abs: Optional[float] = 1e6
                   ) -> "BatchSchema":
        """Infer the schema from an engine's conf: first layer's
        ``n_in`` bounds the feature trailing dim, last layer's
        ``n_out`` the label trailing dim, and a softmax/sigmoid output
        activation implies labels in [0, 1]."""
        layers = list(getattr(model.conf, "layers", ()) or ())
        f_dim = None
        l_dim = None
        l_range = None
        if layers:
            n_in = int(getattr(layers[0], "n_in", 0) or 0)
            n_out = int(getattr(layers[-1], "n_out", 0) or 0)
            f_dim = n_in or None
            l_dim = n_out or None
            act = str(getattr(layers[-1], "activation", "") or "").lower()
            if act in ("softmax", "sigmoid"):
                l_range = (0.0, 1.0)
        return cls(feature_dim=f_dim, label_dim=l_dim,
                   label_range=l_range, max_abs=max_abs)


class BatchValidator:
    """Vectorized host-side batch checks against a
    :class:`BatchSchema`. ``validate(ds)`` returns the violated
    reason codes in a stable order (empty list = clean); `check`
    short-circuits cheap structural failures before touching values,
    so a wrong-dtype batch never trips numpy math on object arrays."""

    def __init__(self, schema: BatchSchema):
        self.schema = schema

    # -- individual checks (each returns a reason code or None) ---------

    def _check_dtype(self, ds) -> Optional[str]:
        s = self.schema
        for arr, kinds in ((ds.features, s.feature_dtype_kinds),
                           (ds.labels, s.label_dtype_kinds)):
            for a in _as_arrays(arr):
                if _np(a).dtype.kind not in kinds:
                    return REASON_DTYPE
        return None

    def _check_shape(self, ds) -> Optional[str]:
        s = self.schema
        feats = _as_arrays(ds.features)
        labs = _as_arrays(ds.labels)
        for a in feats + labs:
            if _np(a).ndim < 2:
                return REASON_SHAPE
        b = _np(feats[0]).shape[0]
        for a in feats + labs:
            if _np(a).shape[0] != b:
                return REASON_SHAPE
        if s.feature_dim is not None:
            for a in feats:
                sh = _np(a).shape
                # dense [b, f] or sequence [b, f, t] layouts both carry
                # the feature dim at axis 1 in this stack
                if sh[1] != s.feature_dim:
                    return REASON_SHAPE
        if s.label_dim is not None:
            for a in labs:
                sh = _np(a).shape
                if sh[1] != s.label_dim:
                    return REASON_SHAPE
        return None

    def _check_mask(self, ds) -> Optional[str]:
        feats = _as_arrays(ds.features)
        b = _np(feats[0]).shape[0]
        for m in (_mask_list(ds, "features_mask")
                  + _mask_list(ds, "labels_mask")):
            ma = _np(m)
            if ma.ndim < 1 or ma.shape[0] != b:
                return REASON_MASK_MISMATCH
            if ma.dtype.kind not in ("f", "i", "u", "b"):
                return REASON_MASK_MISMATCH
        return None

    def _check_values(self, ds) -> List[str]:
        s = self.schema
        reasons: List[str] = []
        finite = True
        magnitude_ok = True
        for a in _as_arrays(ds.features):
            arr = a if _is_tensor(a) else np.asarray(a)
            if _np(arr).dtype.kind != "f":
                continue
            if not _all_finite(arr):
                finite = False
            elif s.max_abs is not None and _max_abs(arr) > s.max_abs:
                magnitude_ok = False
        label_ok = True
        for a in _as_arrays(ds.labels):
            arr = a if _is_tensor(a) else np.asarray(a)
            if _np(arr).dtype.kind == "f" and not _all_finite(arr):
                finite = False
                continue
            if s.label_range is not None:
                lo, hi = s.label_range
                if _np(arr).size:
                    amin, amax = _min_max(arr)
                    if amin < lo or amax > hi:
                        label_ok = False
        if not finite:
            reasons.append(REASON_NON_FINITE)
        if not label_ok:
            reasons.append(REASON_LABEL_RANGE)
        if not magnitude_ok:
            reasons.append(REASON_MAGNITUDE)
        return reasons

    # -- the one public entry point -------------------------------------

    def validate(self, ds) -> List[str]:
        """All violated reason codes for one batch, structural checks
        first (a structural failure suppresses value checks — the
        arrays may not even support numpy math)."""
        r = self._check_dtype(ds)
        if r is not None:
            return [r]
        r = self._check_shape(ds)
        if r is not None:
            return [r]
        reasons = []
        r = self._check_mask(ds)
        if r is not None:
            reasons.append(r)
        reasons.extend(self._check_values(ds))
        return reasons


def _np(a):
    """A host view of a batch field for the structural checks: numpy
    arrays as they are, a tensor through a dtype-and-shape stand-in
    that reads none of its values."""
    if _is_tensor(a):
        return _TensorView(a)
    return np.asarray(a)


def _is_tensor(a) -> bool:
    return torch.is_tensor(a)


class _TensorView:
    """The ``dtype.kind`` / ``ndim`` / ``shape`` of a tensor as numpy
    reports them for the same data, without a copy to the host."""

    def __init__(self, t):
        self.t = t
        self.shape = tuple(t.shape)
        self.ndim = t.dim()
        self.size = t.numel()
        dt = t.dtype
        kind = ("b" if dt == torch.bool else "f" if dt.is_floating_point
                else "c" if dt.is_complex else "u" if dt == torch.uint8
                else "i")
        self.dtype = np.dtype({"b": "?", "f": "f4", "c": "c8", "u": "u1",
                               "i": "i4"}[kind])


def _all_finite(a) -> bool:
    if _is_tensor(a):
        return bool(a.isfinite().all())
    return bool(np.isfinite(a).all())


def _max_abs(a) -> float:
    if _is_tensor(a):
        return float(a.abs().max()) if a.numel() else 0.0
    return float(np.abs(a).max(initial=0.0))


def _min_max(a):
    if _is_tensor(a):
        return float(a.min()), float(a.max())
    return a.min(), a.max()


def _as_arrays(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [a for a in x if a is not None]
    return [x]


def _mask_list(ds, name: str) -> list:
    plural = getattr(ds, name + "s", None)
    single = getattr(ds, name, None)
    return _as_arrays(plural if plural is not None else single)


class QuarantineStore:
    """Bounded forensic store for rejected batches.

    Layout: ``<dir>/manifest.json`` (atomic, one JSON doc) plus one
    ``q-<seq>.npz`` blob per quarantined batch. Every write is
    temp + ``os.replace`` (same discipline as the checkpoint store),
    the manifest lands AFTER its blob, and each entry records
    ``{file, reasons, offset, crc32, size}`` so ``replay()`` can
    CRC-verify before handing a batch back. ``max_bytes`` bounds the
    blob bytes with oldest-first eviction — quarantine is a window
    into recent poison, not an archive."""

    MANIFEST = "manifest.json"

    def __init__(self, directory, max_bytes: int = 64 * 2 ** 20,
                 registry=None):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self._entries: List[dict] = []
        self._seq = 0
        self._load_manifest()

    # -- manifest -------------------------------------------------------

    def _load_manifest(self) -> None:
        path = self.directory / self.MANIFEST
        if not path.exists():
            return
        try:
            doc = json.loads(path.read_text())
            self._entries = list(doc.get("entries", []))
            self._seq = int(doc.get("seq", len(self._entries)))
        except (ValueError, OSError):
            logger.warning("unreadable quarantine manifest %s; "
                           "starting empty", path)

    def _write_manifest(self) -> None:
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_bytes,
        )

        doc = {"format": 1, "seq": self._seq, "entries": self._entries}
        atomic_write_bytes(
            self.directory / self.MANIFEST,
            json.dumps(doc, indent=2).encode(),
        )
        _quarantine_metrics()[1].set(self.total_bytes())

    # -- write ----------------------------------------------------------

    def put(self, ds, reasons: Sequence[str], offset: int) -> dict:
        """Quarantine one rejected batch. Unserializable payloads
        (object arrays from a truly mangled source) are recorded
        manifest-only (``file: null``) — the ledger survives even when
        the bytes cannot."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            atomic_write_bytes,
        )

        entry = {
            "file": None,
            "reasons": list(reasons),
            "offset": int(offset),
            "crc32": None,
            "size": 0,
        }
        try:
            data = ds.to_npz_bytes()
        except Exception:
            logger.warning(
                "quarantined batch at offset %d is unserializable; "
                "recording manifest-only", offset, exc_info=True,
            )
            data = None
        if data is not None:
            fname = f"q-{self._seq:08d}.npz"
            atomic_write_bytes(self.directory / fname, data)
            entry.update(file=fname, size=len(data),
                         crc32=zlib.crc32(data) & 0xFFFFFFFF)
        self._seq += 1
        self._entries.append(entry)
        self._evict()
        self._write_manifest()
        counter = _quarantine_metrics()[0]
        for reason in (reasons or ("unknown",)):
            counter.labels(reason).inc()
        from deeplearning4j_tpu_torch.observability import flightrec
        flightrec.record_event(
            "quarantine", reasons=list(reasons or ("unknown",)),
            offset=int(offset), bytes=int(entry["size"]),
        )
        return entry

    def _evict(self) -> None:
        while (self.total_bytes() > self.max_bytes
               and any(e["file"] for e in self._entries)):
            victim = next(e for e in self._entries if e["file"])
            try:
                os.unlink(self.directory / victim["file"])
            except OSError:
                pass
            # keep the ledger line: the reject HAPPENED even after
            # its bytes age out
            victim.update(file=None, size=0, crc32=None)
            victim["evicted"] = True

    # -- read -----------------------------------------------------------

    def entries(self) -> List[dict]:
        return [dict(e) for e in self._entries]

    def total_bytes(self) -> int:
        return sum(int(e.get("size", 0)) for e in self._entries)

    def replay(self):
        """Yield ``(entry, DataSet)`` for every quarantined batch whose
        blob survives and CRC-verifies (forensics: re-run the
        validator, eyeball the arrays). Corrupt/evicted blobs yield
        ``(entry, None)``."""
        for entry in self._entries:
            ds = None
            if entry.get("file"):
                path = self.directory / entry["file"]
                try:
                    data = path.read_bytes()
                    if (zlib.crc32(data) & 0xFFFFFFFF) == int(
                            entry.get("crc32") or -1):
                        ds = DataSet.from_npz_bytes(data)
                    else:
                        logger.warning(
                            "quarantine blob %s failed CRC", path)
                except OSError:
                    logger.warning("quarantine blob %s unreadable",
                                   path)
            yield dict(entry), ds


class ValidatingIterator(DataSetIterator):
    """``DataSetIterator`` decorator: validate every base batch,
    quarantine the rejects, yield only clean batches.

    A one-item lookahead keeps ``has_next()`` honest when the TAIL of
    the stream is poison (the base may have batches left, all of which
    get rejected). ``offset`` counts batches consumed FROM THE BASE
    (quarantined ones included) — the manifest key that makes a
    resumed stream line up; ``skipped_offsets`` are the rejected ones.
    ``fast_forward(n)`` re-consumes ``n`` base batches without
    validating or yielding (resume: the checkpoint ledger says the
    first ``n`` were already handled)."""

    def __init__(self, base: DataSetIterator, validator: BatchValidator,
                 quarantine: Optional[QuarantineStore] = None,
                 max_quarantined: Optional[int] = None):
        self.base = base
        self.validator = validator
        self.quarantine = quarantine
        self.max_quarantined = max_quarantined
        self.offset = 0                    # base batches consumed
        self.skipped_offsets: List[int] = []
        self.reason_counts: dict = {}
        self._lookahead: Optional[DataSet] = None
        self._plain_iter = None            # lazy iter() over list bases

    # -- resume ---------------------------------------------------------

    def fast_forward(self, n: int) -> None:
        """Skip ``n`` base batches (already consumed before a crash,
        per the checkpoint ledger) without validating them."""
        for _ in range(int(n)):
            if not self._base_has_next():
                break
            self._base_next()
            self.offset += 1

    # -- the filtering core ---------------------------------------------

    def _base_has_next(self) -> bool:
        if hasattr(self.base, "has_next"):
            return self.base.has_next()
        return True  # plain-iterable base: rely on StopIteration

    def _base_next(self) -> DataSet:
        if hasattr(self.base, "next"):
            return self.base.next()
        # plain list/iterable base (the engines' fit accepts those):
        # hold one iter() handle so repeated pulls advance it
        if self._plain_iter is None:
            self._plain_iter = iter(self.base)
        return next(self._plain_iter)

    def _pull_clean(self) -> Optional[DataSet]:
        while self._base_has_next():
            try:
                ds = self._base_next()
            except StopIteration:
                return None
            at = self.offset
            self.offset += 1
            reasons = self.validator.validate(ds)
            if not reasons:
                return ds
            self.skipped_offsets.append(at)
            for reason in reasons:
                self.reason_counts[reason] = (
                    self.reason_counts.get(reason, 0) + 1
                )
            logger.warning(
                "quarantining batch at stream offset %d: %s",
                at, ",".join(reasons),
            )
            if self.quarantine is not None:
                self.quarantine.put(ds, reasons, at)
            else:
                _quarantine_metrics()[0].labels(reasons[0]).inc()
            if (self.max_quarantined is not None
                    and len(self.skipped_offsets)
                    > self.max_quarantined):
                from deeplearning4j_tpu_torch.exceptions import (
                    DL4JFaultException,
                )

                raise DL4JFaultException(
                    f"{len(self.skipped_offsets)} batches "
                    "quarantined (> max_quarantined="
                    f"{self.max_quarantined}) — the source looks "
                    "systematically poisoned, refusing to train on "
                    "the remainder"
                )
        return None

    # -- DataSetIterator SPI --------------------------------------------

    def has_next(self) -> bool:
        if self._lookahead is None:
            self._lookahead = self._pull_clean()
        return self._lookahead is not None

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds = self._lookahead
        self._lookahead = None
        return ds

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()
        self.offset = 0
        self._lookahead = None
        self._plain_iter = None

    def batch(self) -> int:
        return self.base.batch() if hasattr(self.base, "batch") else 0

    def total_examples(self) -> int:
        if hasattr(self.base, "total_examples"):
            return self.base.total_examples()
        return 0

    # -- ledger ---------------------------------------------------------

    def ledger(self) -> dict:
        """The manifest-ready quarantine ledger: how far into the base
        stream we are and which offsets were rejected (what a resumed
        run persists to line its stream up again)."""
        return {
            "offset": int(self.offset),
            "skipped": [int(i) for i in self.skipped_offsets],
            "reasons": dict(self.reason_counts),
        }
