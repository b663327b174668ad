"""The public methods both engines share: ``evaluate``, the flat
parameter view, ``copy``, the AOT entry points, and the line-search
solvers' minibatch.

Counterpart of the same-named methods of the JAX package's
``MultiLayerNetwork`` and ``ComputationGraph`` (JAX
``nn/multilayer.py:1064-1199, :1400-1433``, ``nn/graph.py:911-1055,
:1236-1275``). An engine supplies ``_param_owners()`` (its layer names
in the flat order), ``_aot_shape_key(shape)`` and ``_evaluate_one(e,
ds)``.

AOT on the port (``compile/aot.py``): no program is compiled per shape,
so an ``output`` artifact is a shape record under the model's
fingerprint, and an installed one marks its shape as served without a
first-forward cost (``aot_output_shapes``). A step artifact carries the
features and labels shapes under the step's kind (``step`` plus the
guard, telemetry and transform suffixes); ``aot_install_step`` refuses
an artifact of another kind (its fingerprint differs) and otherwise
wraps the engine's step in an ``AotStepFunction``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import core


def _clone_tree(tree):
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


class EngineApi:
    """Mixed into ``MultiLayerNetwork`` and ``ComputationGraph``."""

    # -- inference bookkeeping --------------------------------------------

    def _note_output(self, tensors) -> None:
        """Record one inference forward's (shapes, dtype) signature
        (``serving.compile_cache.jit_cache_size`` counts them)."""
        self._output_signatures.add(tuple(
            (tuple(int(d) for d in t.shape), str(t.dtype))
            for t in tensors))

    # -- the line-search solvers ------------------------------------------

    def _solver_minibatch(self, x, y, mask=None, fmask=None):
        """A minibatch through the line-search ``optimize.Solver``, built
        at the first one and kept (JAX ``fit_minibatch``'s solver
        route); an unknown ``optimization_algo`` raises ``ValueError``."""
        from deeplearning4j_tpu_torch.optimize.solvers import (
            Solver,
            is_solver_algo,
        )

        if not is_solver_algo(self.conf.optimization_algo):
            raise ValueError("Unknown optimization_algo "
                             f"'{self.conf.optimization_algo}'")
        if self._solver is None:
            self._solver = Solver(self)
        return self._solver.optimize(x, y, mask=mask, fmask=fmask)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, iterator):
        """An ``eval.Evaluation`` over ``iterator`` (DataSets or
        MultiDataSets, or chunks of them): one ``output`` a minibatch,
        its predictions copied to the host once (the engine's
        ``_evaluate_one``). Resets the iterator after."""
        from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        e = Evaluation()
        for item in iterator:
            batches = (item.to_datasets() if isinstance(item, ChunkedDataSet)
                       else [item])
            for ds in batches:
                self._evaluate_one(e, ds)
        if hasattr(iterator, "reset"):
            iterator.reset()
        return e

    # -- the flat parameter view ------------------------------------------

    def _flat_order(self) -> List[Tuple[str, str]]:
        """(layer, param) in the JAX engines' flat order: layer by
        layer, W and b first, the rest sorted."""
        order = []
        for name in self._param_owners():
            pnames = list(self.params[name])
            first = [p for p in ("W", "b") if p in pnames]
            order += [(name, p) for p in
                      first + sorted(p for p in pnames if p not in first)]
        return order

    def params_flat(self) -> np.ndarray:
        """Every parameter, raveled and concatenated on the host."""
        if self.params is None:
            self.init()
        parts = [self.params[ln][pn].detach().cpu().numpy().ravel()
                 for ln, pn in self._flat_order()]
        return np.concatenate(parts) if parts else np.zeros((0,))

    def set_params_flat(self, vec) -> None:
        """The inverse of ``params_flat``."""
        vec = np.asarray(vec)
        order = self._flat_order()
        total = sum(self.params[ln][pn].numel() for ln, pn in order)
        if vec.size != total:
            raise ValueError(f"set_params_flat: {vec.size} values for "
                             f"{total} parameters")
        off = 0
        for ln, pn in order:
            p = self.params[ln][pn]
            n = p.numel()
            self.params[ln][pn] = self._to_device(
                vec[off:off + n].reshape(tuple(p.shape)), p.dtype)
            off += n

    def copy(self):
        """A deep copy on the same device: parameters, layer state and
        updater state cloned (no tensor shared with this model)."""
        if self.params is None:
            self.init()
        core.canonicalize_updater_state(self)
        m = type(self)(self.conf, device=self.device)
        m.init(params=_clone_tree(self.params))
        m.updater_state = _clone_tree(self.updater_state)
        m.state = _clone_tree(self.state)
        return m

    # -- AOT (compile/aot.py) ---------------------------------------------

    def _output_kind(self) -> str:
        return "output" + ("+scan" if self.scan_layers else "")

    def _step_kind(self) -> str:
        from deeplearning4j_tpu_torch.observability.profiler import (
            transform_kind_suffix,
        )

        return ("step"
                + ("+guard" if self.divergence_guard is not None else "")
                + ("+telemetry" if self._telemetry_grad_norm else "")
                + transform_kind_suffix(self))

    def aot_fingerprint(self, shape, kind: Optional[str] = None) -> str:
        """Validity fingerprint of this model's artifacts at ``shape``
        (``compile.aot.artifact_fingerprint``)."""
        from deeplearning4j_tpu_torch.compile.aot import artifact_fingerprint

        return artifact_fingerprint(
            self.conf.to_dict(), self._aot_shape_key(shape),
            str(core.dtype_of(self.conf)).replace("torch.", ""),
            kind if kind is not None else self._output_kind())

    def aot_export_output(self, shape, registry=None) -> bytes:
        """The inference forward's artifact for inputs of exactly
        ``shape`` (the serving bucket contract)."""
        from deeplearning4j_tpu_torch.compile.aot import export_artifact

        key = self._aot_shape_key(shape)
        return export_artifact(
            fingerprint=self.aot_fingerprint(key), shape=key,
            kind=self._output_kind(), name="output-" + "+".join(
                "x".join(str(d) for d in s)
                for s in (key if isinstance(key[0], tuple) else (key,))),
            registry=registry)

    def aot_install_output(self, shape, artifact, registry=None) -> bool:
        """Install an inference artifact for exactly ``shape``
        (fingerprint-checked; a stale or corrupt one is refused and
        counted in ``aot_fallback_total``). True when installed."""
        from deeplearning4j_tpu_torch.compile.aot import load_artifact

        key = self._aot_shape_key(shape)
        if load_artifact(artifact,
                         expected_fingerprint=self.aot_fingerprint(key),
                         registry=registry) is None:
            return False
        self._aot_outputs[key] = True
        return True

    def aot_output_shapes(self) -> list:
        """Input shapes with an installed inference artifact."""
        return list(self._aot_outputs)

    def _step_shapes(self, ds):
        x, y = ds.features, ds.labels
        if isinstance(x, (list, tuple)):
            return (self._aot_shape_key([np.shape(a) for a in x]),
                    self._aot_shape_key([np.shape(a) for a in y]))
        return (tuple(int(d) for d in np.shape(x)),
                tuple(int(d) for d in np.shape(y)))

    def aot_export_step(self, ds, registry=None) -> bytes:
        """The train step's artifact at ``ds``'s features / labels
        shapes (no masks), under the step's current kind."""
        from deeplearning4j_tpu_torch.compile.aot import (
            _shape_key_to_list,
            export_artifact,
        )

        x_key, y_key = self._step_shapes(ds)
        kind = self._step_kind()
        return export_artifact(
            fingerprint=self.aot_fingerprint(x_key, kind=kind),
            shape=x_key, kind=kind, name="step",
            meta_extra={"label_shape": _shape_key_to_list(y_key)},
            registry=registry)

    def aot_install_step(self, artifact, registry=None) -> bool:
        """Install a train-step artifact: refused (False, counted) when
        its kind or shapes' fingerprint is not this model's; else the
        step becomes an ``AotStepFunction`` over the engine's step."""
        from deeplearning4j_tpu_torch.compile.aot import (
            AotArtifactError,
            AotStepFunction,
            load_artifact,
            peek_meta,
        )

        try:
            meta = peek_meta(artifact)
            x_key = self._aot_shape_key(meta["shape"])
            y_key = self._aot_shape_key(meta["label_shape"])
        except (AotArtifactError, KeyError, TypeError):
            return False
        kind = self._step_kind()
        if load_artifact(artifact, expected_fingerprint=self.aot_fingerprint(
                x_key, kind=kind), registry=registry) is None:
            return False
        self._step = None  # the engine's own step, never a wrapper
        self._step = AotStepFunction(self._train_step(), x_key, y_key, kind)
        return True
