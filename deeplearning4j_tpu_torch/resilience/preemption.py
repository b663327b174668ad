"""Signal-driven preemption handling.

Counterpart of ``deeplearning4j_tpu/resilience/preemption.py``. A
preemptible machine gets SIGTERM and a short grace window before it
goes; the trainer turns the signal into an emergency checkpoint in
that window. :class:`PreemptionHandler` installs SIGTERM / SIGINT
handlers (and :meth:`PreemptionHandler.notify`, a simulated notice
with the same consequences) that set a flag. Every fit driver polls it
at step boundaries through :func:`check_fit` (both engines' fit loop
``nn/core.fit_batches`` and ``DistributedTrainer.fit`` per step, per
chunk under megastep) and, once it is set, runs :meth:`emergency_stop`:

1. **quiesce**: drain the ``AsyncDispatchWindow`` (the steps in flight
   complete, the guard's flags are collected) and shut the
   ``PrefetchIterator`` worker down with a bounded join, so the save
   below never races a worker thread mid-copy;
2. **checkpoint**: a synchronous save through the ``CheckpointManager``
   (it drains any write-behind save first), with the flight recorder's
   ring attached as the ``flightrec.jsonl`` artifact when one is
   installed;
3. **raise**: :class:`PreemptedException` (its ``step`` the saved
   iteration) unwinds the fit; :func:`exit_on_preemption` turns it
   into an exit code.

Exit codes (the JAX package's): ``EXIT_PREEMPTED`` (75, ``EX_TEMPFAIL``)
when the emergency checkpoint landed, ``EXIT_PREEMPTED_DIRTY`` (76)
when no checkpoint was written. ``install`` saves the previous signal
dispositions and ``uninstall`` restores them.
"""

from __future__ import annotations

import contextlib
import logging
import signal as _signal
import sys
import threading
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.exceptions import DL4JFaultException

logger = logging.getLogger(__name__)

# sysexits.h EX_TEMPFAIL: "try again later" — exactly what a
# preempted-but-checkpointed trainer means to its supervisor
EXIT_PREEMPTED = 75
# preempted without a durable emergency checkpoint (no manager, or
# the save failed): restart resumes from the previous version
EXIT_PREEMPTED_DIRTY = 76

DEFAULT_SIGNALS = (_signal.SIGTERM, _signal.SIGINT)


class PreemptedException(DL4JFaultException):
    """Raised from a fit loop's step boundary after the emergency
    checkpoint attempt. ``checkpoint`` is the ``CheckpointInfo`` when
    the save landed (None otherwise); ``checkpoint_failed`` is True
    when a save was attempted and raised."""

    def __init__(self, message: str, step: Optional[int] = None,
                 checkpoint=None, checkpoint_failed: bool = False,
                 reason: str = "signal"):
        super().__init__(message)
        self.step = step
        self.checkpoint = checkpoint
        self.checkpoint_failed = checkpoint_failed
        self.reason = reason

    @property
    def exit_code(self) -> int:
        if self.checkpoint is not None and not self.checkpoint_failed:
            return EXIT_PREEMPTED
        return EXIT_PREEMPTED_DIRTY


_lock = threading.Lock()
_active: Optional["PreemptionHandler"] = None


def active_handler() -> Optional["PreemptionHandler"]:
    """The installed handler, or None (no preemption handling)."""
    return _active


def preemption_requested() -> bool:
    """True when a handler is installed and a notice has arrived.
    The no-handler fast path is one global read — cheap enough for
    every step boundary in every fit driver."""
    h = _active
    return h is not None and h.requested


def check_fit(model=None, *, manager=None, window=None, prefetch=None,
              checkpoint_fn: Optional[Callable] = None,
              artifacts=None) -> None:
    """Step-boundary poll used by the fit drivers: no-op until a
    preemption notice arrives, then :meth:`PreemptionHandler.
    emergency_stop` (drain + checkpoint + raise). See module
    docstring for who calls this."""
    h = _active
    if h is None or not h.requested:
        return
    h.emergency_stop(model, manager=manager, window=window,
                     prefetch=prefetch, checkpoint_fn=checkpoint_fn,
                     artifacts=artifacts)


@contextlib.contextmanager
def exit_on_preemption():
    """Process-level wrapper: translate :class:`PreemptedException`
    into the documented exit code::

        with exit_on_preemption():
            trainer.fit(iterator, epochs=50)
    """
    try:
        yield
    except PreemptedException as e:
        logger.info("exiting on preemption (%s): exit code %d",
                    e.reason, e.exit_code)
        sys.exit(e.exit_code)


class PreemptionHandler:
    """Install SIGTERM/SIGINT -> atomic-flag translation (module
    docstring). ``manager`` (a ``CheckpointManager``) is the default
    emergency-checkpoint target when a fit driver has none of its
    own; ``artifact_fn(model)`` supplies the artifacts map attached
    to the emergency save (e.g. the AOT serving bundle).

    Usable as a context manager (install on enter, uninstall on
    exit). ``notify()`` is the chaos-injectable simulated preemption
    notice: identical consequences to the real signal, no process
    state touched — tests drive the whole emergency path with it.
    """

    def __init__(self, manager=None, *,
                 artifact_fn: Optional[Callable] = None,
                 signals=DEFAULT_SIGNALS,
                 drain_timeout: float = 5.0,
                 registry=None):
        self.manager = manager
        self.artifact_fn = artifact_fn
        self.signals = tuple(signals)
        self.drain_timeout = float(drain_timeout)
        self._flag = threading.Event()
        self._reason: str = ""
        self._prev = {}
        self._callbacks: List[Callable] = []
        self._cb_lock = threading.Lock()
        if registry is None:
            from deeplearning4j_tpu_torch.observability.metrics import (
                default_registry,
            )

            registry = default_registry()
        self._m_notices = registry.counter(
            "preemption_notices_total",
            help="preemption notices observed (signals + simulated)",
        )._default()
        self._m_checkpoints = registry.counter(
            "preemption_emergency_checkpoints_total",
            help="emergency checkpoints written on preemption",
        )._default()
        self._m_drain_ms = registry.summary(
            "preemption_drain_ms",
            help="notice -> quiesced-and-checkpointed latency (ms)",
        )._default()

    # -- install / uninstall --------------------------------------------

    def install(self) -> "PreemptionHandler":
        """Install the signal handlers (main thread only — a
        ``signal.signal`` constraint) and make this the process-wide
        active handler that ``check_fit`` consults. The previous
        dispositions are saved for :meth:`uninstall`."""
        global _active
        for sig in self.signals:
            self._prev[sig] = _signal.signal(sig, self._on_signal)
        with _lock:
            _active = self
        return self

    def uninstall(self) -> None:
        """Restore the saved signal dispositions and deactivate."""
        global _active
        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):  # non-main thread teardown
                pass
        self._prev.clear()
        with _lock:
            if _active is self:
                _active = None

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- the notice -----------------------------------------------------

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    @property
    def reason(self) -> str:
        return self._reason

    def clear(self) -> None:
        """Reset the flag (tests; a real notice is never unset)."""
        self._flag.clear()
        self._reason = ""

    def notify(self, reason: str = "simulated") -> None:
        """Deliver a preemption notice. Called by the signal handler
        with the signal name, or directly by chaos tests — the
        simulated notice and the real signal are indistinguishable
        downstream. Idempotent: repeat notices don't re-run
        callbacks."""
        first = not self._flag.is_set()
        self._reason = self._reason or reason
        self._flag.set()
        if not first:
            return
        self._notified_at = time.monotonic()
        self._m_notices.inc()
        logger.warning("preemption notice received (%s)", reason)
        with self._cb_lock:
            callbacks = list(self._callbacks)
        if callbacks:
            # never run drains inside the signal frame: hand them to
            # a thread so the interrupted main thread resumes fast
            t = threading.Thread(
                target=self._run_callbacks, args=(callbacks, reason),
                daemon=True, name="dl4j-preemption-drain",
            )
            t.start()

    def _run_callbacks(self, callbacks, reason) -> None:
        for cb in callbacks:
            try:
                cb(reason)
            except Exception:
                logger.exception("preemption callback failed")

    def _on_signal(self, signum, frame) -> None:
        try:
            name = _signal.Signals(signum).name
        except ValueError:  # pragma: no cover
            name = f"signal-{signum}"
        self.notify(reason=name)

    def on_preemption(self, callback: Callable) -> "PreemptionHandler":
        """Register ``callback(reason)`` to run (on a daemon thread)
        when the notice arrives — the serving tier registers its
        graceful drain here. A callback registered after the notice
        runs immediately on the caller's thread."""
        with self._cb_lock:
            self._callbacks.append(callback)
        if self._flag.is_set():
            self._run_callbacks([callback], self._reason or "signal")
        return self

    # -- the emergency path ---------------------------------------------

    def emergency_stop(self, model=None, *, manager=None, window=None,
                       prefetch=None,
                       checkpoint_fn: Optional[Callable] = None,
                       artifacts=None) -> None:
        """Quiesce -> emergency checkpoint -> raise (module
        docstring). Always raises :class:`PreemptedException`; the
        drain legs run in try/finally so the checkpoint never races a
        worker thread, and a drain fault is chained onto the raised
        exception instead of masking it."""
        t0 = time.monotonic()
        step = int(getattr(model, "iteration_count", 0)) if model is not None else None
        drain_fault: Optional[BaseException] = None
        try:
            try:
                if window is not None:
                    window.drain()
            finally:
                if prefetch is not None:
                    shutdown = getattr(prefetch, "shutdown", None)
                    if shutdown is not None:
                        try:
                            shutdown(timeout=self.drain_timeout,
                                     raise_pending=True)
                        except TypeError:
                            # plain iterators without the bounded
                            # signature (AsyncDataSetIterator)
                            shutdown()
        except Exception as e:
            # the window may surface a guard abort, the prefetch a
            # pending worker fault: neither may cost us the
            # checkpoint — the grace window is already ticking
            drain_fault = e
            logger.warning("drain fault during emergency stop "
                           "(checkpointing anyway): %r", e)
        info = None
        failed = False
        mgr = manager if manager is not None else self.manager
        from deeplearning4j_tpu_torch.observability import flightrec

        rec = flightrec.get_flight_recorder()
        if rec is not None and rec.enabled:
            rec.event("preemption_notice",
                      reason=self._reason or "notice", step=step)
        try:
            if checkpoint_fn is not None:
                info = checkpoint_fn()
            elif mgr is not None and model is not None:
                arts = artifacts
                if arts is None and self.artifact_fn is not None:
                    arts = self.artifact_fn(model)
                if rec is not None and rec.enabled:
                    # the ring rides the emergency manifest as a
                    # CRC-verified artifact: the postmortem (last-N
                    # steps, timings, MFU, events) travels WITH the
                    # checkpoint the resume will load. The dump runs
                    # after the drain above, so its last step record
                    # is the step the checkpoint (and resume) is at.
                    try:
                        arts = dict(arts) if arts else {}
                        arts.setdefault(
                            "flightrec.jsonl",
                            rec.dump_bytes(reason="preemption"),
                        )
                    except Exception:  # never cost us the checkpoint
                        logger.exception(
                            "flight-recorder artifact dump failed")
                # force the synchronous path: it drains any
                # write-behind save first, so the emergency
                # checkpoint is complete, durable, and the newest on
                # disk when the exit code promises "checkpointed"
                try:
                    info = mgr.save(model, artifacts=arts,
                                    mode="sync")
                except TypeError:
                    # duck-typed managers without a mode kwarg
                    info = mgr.save(model, artifacts=arts)
        except Exception:
            failed = True
            logger.exception("emergency checkpoint failed at step %s",
                             step)
        if info is not None and not failed:
            self._m_checkpoints.inc()
            logger.warning(
                "emergency checkpoint written at step %d (%s)",
                getattr(info, "step", -1), self._reason or "notice",
            )
        self._m_drain_ms.observe((time.monotonic() - t0) * 1000.0)
        exc = PreemptedException(
            f"preempted ({self._reason or 'notice'}) at step {step}; "
            + ("emergency checkpoint written"
               if info is not None and not failed
               else "no emergency checkpoint"),
            step=step, checkpoint=info, checkpoint_failed=failed,
            reason=self._reason or "notice",
        )
        if drain_fault is not None:
            exc.__cause__ = drain_fault
        raise exc
