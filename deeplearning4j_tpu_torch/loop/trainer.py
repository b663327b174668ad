"""Continual training: stream in, versioned checkpoints out.

Counterpart of ``deeplearning4j_tpu/loop/trainer.py``.

``ContinualTrainer`` closes the producer half of the continuous-
learning loop: it consumes a streaming ``DataSetIterator`` (or any
iterable of ``DataSet``s) through the existing fit machinery — either
an engine's ``fit_minibatch`` or a ``DistributedTrainer``'s — and
publishes a versioned checkpoint through ``CheckpointManager`` every
``publish_every`` optimizer steps, with the serving AOT bundle
attached when ``aot_buckets`` is set (``compile.aot.
export_serving_bundle``: the kernel library and the buckets' shape
records), so a promotion's server builds no kernel.

Crash-safety is inherited, not reinvented: checkpoints are atomic +
CRC-manifested, and ``resume()`` restores the newest restorable
version (params, updater state, step counter) so a trainer killed
mid-epoch replays the *identical* trajectory the uninterrupted run
would have taken (``tests/test_torch_loop.py`` asserts this bitwise;
with a validator, the manifest's data ledger fast-forwards the stream
past the batches already fit or quarantined).

The publish cadence is step-based, not time-based, on purpose: a
resumed trainer re-publishes the same step numbers it would have
published uninterrupted, so the promoter downstream sees one
consistent version line regardless of how many times the trainer
died.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Optional

logger = logging.getLogger(__name__)


class ContinualTrainer:
    """Incrementally fit a model from a stream and publish versioned
    checkpoints.

    ``model`` is a ``MultiLayerNetwork``/``ComputationGraph``;
    ``trainer`` (optional) a ``DistributedTrainer`` wrapping the same
    model — steps then run through its sharded fit path.
    ``artifact_fn`` overrides the AOT exporter (tests inject stub
    blobs; the default exports the serving bundle for
    ``aot_buckets``). ``journal`` (a ``PromotionJournal``) wires the
    retention contract: steps the journal references are never
    pruned.
    """

    def __init__(self, model, manager, *, publish_every: int = 8,
                 trainer=None, aot_buckets=None,
                 artifact_fn: Optional[Callable] = None,
                 feature_shape=None, journal=None, registry=None,
                 validator=None, quarantine=None):
        if publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        self.model = model
        self.manager = manager
        self.trainer = trainer
        # data-plane defense: a datasets.BatchValidator screens every
        # stream batch before it reaches fit; offenders land in the
        # datasets.QuarantineStore and the quarantine ledger rides the
        # published manifests (bitwise kill/resume)
        self.validator = validator
        self.quarantine = quarantine
        self._resume_ledger = None
        self.publish_every = int(publish_every)
        self.aot_buckets = list(aot_buckets) if aot_buckets else None
        self.feature_shape = feature_shape
        self._artifact_fn = artifact_fn
        self.last_published = None  # CheckpointInfo of newest publish
        if journal is not None:
            # retention contract: pruning must never delete a step the
            # promotion journal still references (rollback target!)
            manager.protect = journal.referenced_steps
        if registry is None:
            from deeplearning4j_tpu_torch.observability.metrics import (
                default_registry,
            )

            registry = default_registry()
        self._m_steps = registry.counter(
            "loop_train_steps_total",
            help="loop: optimizer steps consumed from the stream",
        )._default()
        self._m_published = registry.counter(
            "loop_published_total",
            help="loop: versioned checkpoints published",
        )._default()
        self._m_published_step = registry.gauge(
            "loop_published_step",
            help="loop: step of the newest published checkpoint",
        )._default()

    # -- resume ---------------------------------------------------------

    def resume(self, load_updater: bool = True) -> int:
        """Restore the newest restorable checkpoint into the model (or
        through the distributed trainer, which re-places params onto
        its mesh) and return the restored step; 0 when the store is
        empty (fresh start)."""
        if self.manager.latest_step() is None:
            return 0
        target = self.trainer if self.trainer is not None else self.model
        step = target.resume(self.manager,
                             load_updater=load_updater)
        self.last_published = next(
            (i for i in self.manager.available() if i.step == step),
            None,
        )
        # restore_into applied the manifest's guard doc; the data
        # ledger it left on the model tells the next run() how many
        # BASE batches (quarantined ones included) are already handled
        self._resume_ledger = getattr(self.model, "_data_ledger", None)
        logger.info("continual trainer resumed at step %d", step)
        return step

    # -- publish --------------------------------------------------------

    def _artifacts(self) -> Optional[dict]:
        if self._artifact_fn is not None:
            return self._artifact_fn(self.model)
        if not self.aot_buckets:
            return None
        from deeplearning4j_tpu_torch.compile.aot import (
            export_serving_bundle,
        )

        return export_serving_bundle(
            self.model, self.aot_buckets,
            feature_shape=self.feature_shape,
        )

    def publish(self, mode: Optional[str] = None) -> "CheckpointInfo":
        """Checkpoint the model at its current step, AOT bundle
        attached. Export failures degrade to a bundle-less publish
        (the consumer then builds the kernel library and runs its
        buckets as new shapes — a lost bundle costs a build, never a
        version). ``mode`` rides through to
        ``CheckpointManager.save``: with an async manager (or
        ``mode="async"``) the publish is write-behind and this
        returns the :class:`AsyncSaveHandle` (its ``step`` is final;
        the manifest lands in the background)."""
        artifacts = None
        try:
            artifacts = self._artifacts()
        except Exception:
            logger.warning(
                "AOT export failed at step %d; publishing without a "
                "bundle", int(self.model.iteration_count),
                exc_info=True,
            )
        info = self.manager.save(self.model, artifacts=artifacts,
                                 mode=mode)
        self.last_published = info
        self._m_published.inc()
        self._m_published_step.set(info.step)
        logger.info("published checkpoint step %d (%d artifacts)",
                    info.step, len(getattr(info, "artifacts", None)
                                   or {}))
        return info

    def _publish_sync(self) -> "CheckpointInfo":
        """Emergency-path publish: always synchronous, so the
        preemption exit code never promises a checkpoint that a
        background writer has yet to finish."""
        return self.publish(mode="sync")

    # -- the stream loop ------------------------------------------------

    def run(self, stream: Iterable, max_steps: Optional[int] = None,
            publish_trailing: bool = True) -> int:
        """Consume ``stream`` (a ``DataSetIterator`` or any iterable
        of minibatches), fitting one optimizer step per batch and
        publishing every ``publish_every`` steps. Returns the number
        of steps consumed THIS call. ``max_steps`` bounds the call
        (tests and budget-boxed demos); ``publish_trailing`` also
        publishes a final partial window so a drained stream never
        strands unpublished progress."""
        from deeplearning4j_tpu_torch.resilience import preemption

        fit = (self.trainer.fit_minibatch if self.trainer is not None
               else self.model.fit_minibatch)
        vit = None
        if self.validator is not None:
            from deeplearning4j_tpu_torch.datasets.validate import (
                ValidatingIterator,
            )

            if isinstance(stream, ValidatingIterator):
                vit = stream
            else:
                vit = stream = ValidatingIterator(
                    stream, self.validator, quarantine=self.quarantine,
                )
            led = self._resume_ledger
            if led and vit.offset == 0:
                # bitwise resume: the manifest ledger says the first
                # `offset` base batches were already fit/quarantined —
                # re-consume them unvalidated and seed the ledger so
                # published counts keep accumulating, not restarting
                vit.fast_forward(int(led.get("offset", 0)))
                vit.skipped_offsets = [
                    int(i) for i in led.get("skipped", [])
                ]
                vit.reason_counts = {
                    str(k): int(v)
                    for k, v in (led.get("reasons") or {}).items()
                }
            self._resume_ledger = None
        consumed = 0
        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        run_span = get_tracer().start_span(
            "train.continual.run",
            attrs={"start_step": int(self.model.iteration_count),
                   "publish_every": int(self.publish_every)},
        )
        try:
            for ds in self._iter(stream):
                # preemption notice -> emergency publish through THIS
                # trainer's publish() (AOT artifacts attached, journal
                # retention honored), then PreemptedException
                preemption.check_fit(
                    self.model, checkpoint_fn=self._publish_sync,
                    prefetch=stream
                    if hasattr(stream, "shutdown") else None,
                )
                fit(ds)
                consumed += 1
                self._m_steps.inc()
                if vit is not None:
                    # snapshot AFTER the fit so a publish (scheduled
                    # or preemption-emergency) never claims a base
                    # batch the params don't yet reflect
                    self.model._data_ledger = vit.ledger()
                if self.model.iteration_count % self.publish_every == 0:
                    self.publish()
                if max_steps is not None and consumed >= max_steps:
                    break
            if publish_trailing and consumed and (
                self.last_published is None
                or self.last_published.step < self.model.iteration_count
            ):
                self.publish()
        except BaseException as e:
            run_span.set_attr("steps", consumed)
            run_span.end(status=type(e).__name__)
            raise
        run_span.set_attr("steps", consumed)
        run_span.end()
        return consumed

    @staticmethod
    def _iter(stream):
        if hasattr(stream, "has_next") and hasattr(stream, "next"):
            while stream.has_next():
                yield stream.next()
        else:
            yield from stream
