"""``ParallelWrapper``: the reference's parameter averaging.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (reference
``parallelism/ParallelWrapper.java:37,:138-177`` and
``ParameterAveragingTrainingMaster.java:74``: N model replicas each fit
``averaging_frequency`` minibatches from their own data, then their
parameters, optionally their updater state, and their layer state
(BatchNormalization's running statistics) are averaged and
redistributed). The JAX package stacks the replicas on a leading axis
and steps them under ``vmap``; here each replica is a copy of the
model's parameters, updater state and layer state on a device of the
caller's (``devices``; all on the model's device by default, so on one
card they all sit on it), stepped one after another by the model's own
train step, and averaged on the model's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn import core, random
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


def _copy_tree(tree, device):
    return {ln: {k: (tuple(t.to(device, copy=True) for t in v)
                     if isinstance(v, tuple) else v.to(device, copy=True))
                 for k, v in lp.items()}
            for ln, lp in tree.items()}


def _mean_tree(trees, device):
    """The elementwise mean of replica trees, taken on ``device``."""
    first = trees[0]
    out = {}
    for ln, lp in first.items():
        out[ln] = {}
        for k, v in lp.items():
            if isinstance(v, tuple):
                out[ln][k] = tuple(
                    torch.stack([tr[ln][k][i].to(device) for tr in trees])
                    .mean(0) for i in range(len(v)))
            elif v.is_floating_point():
                out[ln][k] = torch.stack(
                    [tr[ln][k].to(device) for tr in trees]).mean(0)
            else:
                out[ln][k] = v.to(device)
    return out


class ParallelWrapper:
    def __init__(self, model, workers: int = 2,
                 averaging_frequency: int = 1,
                 average_updaters: bool = True,
                 prefetch_buffer: int = 0,
                 devices: Optional[Sequence] = None):
        """``workers`` replicas of ``model``, on ``devices`` (one a
        replica, cycled; default the model's device). ``prefetch_buffer``
        > 0 raises: the prefetching input pipeline is not ported."""
        if prefetch_buffer:
            raise NotImplementedError(
                "prefetch_buffer: the prefetching input pipeline arrives "
                "with the runtime subsystems slice (datasets/prefetch.py)")
        self.model = model
        self.workers = int(workers)
        self.averaging_frequency = max(int(averaging_frequency), 1)
        self.average_updaters = average_updaters
        devs = list(devices) if devices is not None else [model.device]
        self.devices = [resolve_device(devs[i % len(devs)])
                        for i in range(self.workers)]
        if model.params is None:
            model.init()
        self._replicas: Optional[List[dict]] = None
        self._steps_since_avg = 0

    # -- replica plumbing ------------------------------------------------

    def _ensure_replicas(self) -> None:
        if self._replicas is None:
            m = self.model
            self._replicas = [
                {"params": _copy_tree(m.params, d),
                 "upd": _copy_tree(m.updater_state, d),
                 "state": _copy_tree(m.state, d)} for d in self.devices]

    def fit(self, iterator, epochs: int = 1) -> None:
        """Each round hands one minibatch to each replica (reference: the
        MagicQueue spreading batches over the device queues); a trailing
        partial round recycles the epoch's batches to fill every
        replica. The averaged replicas are folded back into the model at
        the end."""
        m = self.model
        m._check_trainable()
        self._ensure_replicas()
        for _ in range(epochs):
            buf = []
            for ds in iter(iterator):
                buf.append(ds)
                if len(buf) == self.workers:
                    self._round(buf)
                    buf = []
            if buf:
                orig = len(buf)
                while len(buf) < self.workers:
                    buf.append(buf[len(buf) % orig])
                self._round(buf)
            if hasattr(iterator, "reset"):
                iterator.reset()
            m.epoch_count += 1
        self._sync_model()

    def _round(self, batches) -> None:
        """One step of every replica on its own minibatch (the same
        learning rates and iteration count), then the averaging round
        every ``averaging_frequency`` steps."""
        m = self.model
        step = m._train_step()
        lrs = m.updater_def.scheduled_lrs(m.iteration_count)
        t = m.iteration_count + 1
        scores = []
        home = m.device
        # replica i draws its masks from fold_in(step key, i), as in JAX
        rng = core.step_rng(m, m.iteration_count)
        for i, (rep, ds, dev) in enumerate(zip(self._replicas, batches,
                                               self.devices)):
            x, y, lm, fm = m.batch_tensors(ds, dev)
            out = step(rep["params"], rep["upd"], rep["state"], x, y, lm,
                       lrs, t, fm,
                       rng=None if rng is None else random.fold_in(rng, i))
            rep["params"], rep["upd"], rep["state"] = out[:3]
            score = out.score
            for name in m.recurrent_names():
                rep["state"][name] = {}
            scores.append(score.to(home))
        m.iteration_count += 1
        self._steps_since_avg += 1
        if self._steps_since_avg >= self.averaging_frequency:
            self._average()
        m._last_score = torch.stack(scores).mean()

    def _average(self) -> None:
        """The averaging round (reference ``Nd4j.averageAndPropagate``;
        updater averaging per ``ParallelWrapper.java:168-177``). Layer
        state averages too: in the reference BN's running statistics
        are parameters."""
        home = self.model.device
        keys = ["params", "state"] + (["upd"] if self.average_updaters
                                      else [])
        for key in keys:
            avg = _mean_tree([r[key] for r in self._replicas], home)
            for rep, dev in zip(self._replicas, self.devices):
                rep[key] = _copy_tree(avg, dev)
        self._steps_since_avg = 0

    def _sync_model(self) -> None:
        """Fold the averaged replicas back into the wrapped model
        (reference: the master model is updated after averaging)."""
        if self._replicas is None:
            return
        if self._steps_since_avg:
            self._average()
        home = self.model.device
        rep = self._replicas[0]
        self.model.params = _copy_tree(rep["params"], home)
        self.model.updater_state = _copy_tree(rep["upd"], home)
        self.model.state = _copy_tree(rep["state"], home)
        self._replicas = None
