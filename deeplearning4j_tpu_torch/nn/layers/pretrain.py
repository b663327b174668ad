"""Layer-wise pretraining layers: the denoising AutoEncoder and the RBM.

Counterpart of ``deeplearning4j_tpu/nn/layers/pretrain.py``. Both keep
tied weights ``W [n_in, n_out]`` with a hidden bias ``b`` and a visible
bias ``vb``, and both products are plain PyTorch, as they are plain XLA
in the JAX package (no Pallas kernel computes them).

- ``AutoEncoder``: ``encode = act(x W + b)``, ``decode = act(h Wᵀ + vb)``;
  its ``pretrain_loss`` corrupts the input with masking noise (each
  entry kept with probability ``1 - corruption_level``, drawn as
  ``jax.random.bernoulli`` draws it) and scores the reconstruction's
  pre-activation against the clean input with ``loss``.
- ``RBM``: ``BINARY`` / ``GAUSSIAN`` visible and ``BINARY`` /
  ``RECTIFIED`` hidden units (the others are refused at init). CD-k runs
  through the free-energy identity: the gradient of ``mean(E'(v_data) -
  E'(v_model))``, with ``E'`` the energy at the hidden unit's own
  conditional mean held constant (``_pseudo_energy``), is the CD update
  for either hidden unit. The k-step ``gibbs_chain`` runs under
  ``torch.no_grad`` (JAX's ``stop_gradient``), each step's keys
  ``split(key, 3)`` of the carried key, its samples ``nn/random.py``'s
  ``bernoulli`` and ``normal``. The score the loss reports is the
  reconstruction error (a term with zero gradient).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import random
from deeplearning4j_tpu_torch.nn.layers.base import (
    FeedForwardLayerSpec,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _tied_params(layer, gen, dtype) -> dict:
    w = init_weights(
        gen, (layer.n_in, layer.n_out), layer.weight_init,
        fan_in=layer.n_in, fan_out=layer.n_out,
        distribution=layer.dist, dtype=dtype,
    )
    return {
        "W": w,
        "b": torch.full((layer.n_out,), float(layer.bias_init), dtype=dtype),
        "vb": torch.full((layer.n_in,), float(layer.bias_init), dtype=dtype),
    }


@register_layer
@dataclass(frozen=True)
class AutoEncoder(FeedForwardLayerSpec):
    """Denoising autoencoder with tied weights (reference
    ``AutoEncoder.java``: encode sigmoid(xW+b), decode sigmoid(hWᵀ+vb),
    masking-noise corruption ``corruptionLevel``)."""

    corruption_level: float = 0.3
    loss: str = "XENT"

    def is_pretrainable(self) -> bool:
        return True

    def init_params(self, gen, dtype=torch.float32) -> dict:
        return _tied_params(self, gen, dtype)

    def encode(self, params, x):
        return self.activate_fn()(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self.activate_fn()(h @ params["W"].t() + params["vb"])

    def supports_drop_connect(self) -> bool:
        return True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        params = self.maybe_drop_connect(params, train=train, rng=rng)
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, rng):
        corrupted = x
        if rng is not None and self.corruption_level > 0.0:
            keep = random.bernoulli(rng, 1.0 - self.corruption_level,
                                    x.shape, device=x.device)
            corrupted = torch.where(keep, x, 0.0)
        h = self.encode(params, corrupted)
        recon_pre = h @ params["W"].t() + params["vb"]
        return losses_mod.score(self.loss, x, recon_pre, self.activation,
                                None, True)


@register_layer
@dataclass(frozen=True)
class RBM(FeedForwardLayerSpec):
    """Restricted Boltzmann machine trained by CD-k (reference
    ``RBM.java``: ``contrastiveDivergence``, the ``gibbhVh`` chain).
    ``visible_unit``: BINARY | GAUSSIAN; ``hidden_unit``: BINARY |
    RECTIFIED (the reference's SOFTMAX is refused at init, as in the
    JAX package)."""

    visible_unit: str = "BINARY"
    hidden_unit: str = "BINARY"
    k: int = 1

    def is_pretrainable(self) -> bool:
        return True

    def init_params(self, gen, dtype=torch.float32) -> dict:
        if self.visible_unit not in ("BINARY", "GAUSSIAN"):
            raise ValueError(f"Unsupported visible_unit {self.visible_unit}")
        if self.hidden_unit not in ("BINARY", "RECTIFIED"):
            raise ValueError(f"Unsupported hidden_unit {self.hidden_unit}")
        return _tied_params(self, gen, dtype)

    # -- conditionals -------------------------------------------------------

    def _hidden_mean(self, params, v):
        pre = v @ params["W"] + params["b"]
        if self.hidden_unit == "RECTIFIED":
            return torch.clamp_min(pre, 0.0)
        return torch.sigmoid(pre)

    def _sample_hidden(self, params, v, key):
        pre = v @ params["W"] + params["b"]
        if self.hidden_unit == "RECTIFIED":
            # NReLU: max(0, pre + N(0, sigmoid(pre)))
            noise = random.normal(key, pre.shape, device=pre.device)
            return torch.clamp_min(
                pre + noise.to(pre.dtype) * torch.sqrt(torch.sigmoid(pre)),
                0.0)
        return random.bernoulli(key, torch.sigmoid(pre)).to(pre.dtype)

    def _visible_mean(self, params, h):
        pre = h @ params["W"].t() + params["vb"]
        if self.visible_unit == "GAUSSIAN":
            return pre
        return torch.sigmoid(pre)

    def _sample_visible(self, params, h, key):
        mean = self._visible_mean(params, h)
        if self.visible_unit == "GAUSSIAN":
            return mean + random.normal(key, mean.shape,
                                        device=mean.device).to(mean.dtype)
        return random.bernoulli(key, mean).to(mean.dtype)

    def free_energy(self, params, v):
        """F(v) for monitoring; binary hidden units only: ``-v·vb -
        Σ softplus(vW + b)``, a Gaussian visible layer ``0.5‖v − vb‖²``
        in place of ``-v·vb``."""
        if self.hidden_unit != "BINARY":
            raise ValueError(
                "free_energy has a closed form only for BINARY hidden "
                f"units (got {self.hidden_unit})")
        pre_h = v @ params["W"] + params["b"]
        hidden_term = torch.sum(F.softplus(pre_h), dim=-1)
        if self.visible_unit == "GAUSSIAN":
            vis_term = 0.5 * torch.sum((v - params["vb"]) ** 2, dim=-1)
            return vis_term - hidden_term
        return -(v @ params["vb"]) - hidden_term

    def _pseudo_energy(self, params, v):
        """The energy at the hidden unit's conditional mean held
        constant: its gradient in (W, b, vb) is the per-phase CD
        statistic ``-vᵀE[h|v], -E[h|v], -v`` for either hidden unit."""
        h = self._hidden_mean(params, v).detach()
        pre_h = v @ params["W"] + params["b"]
        hidden_term = torch.sum(h * pre_h, dim=-1)
        if self.visible_unit == "GAUSSIAN":
            vis_term = 0.5 * torch.sum((v - params["vb"]) ** 2, dim=-1)
            return vis_term - hidden_term
        return -(v @ params["vb"]) - hidden_term

    # -- the supervised forward: propUp -------------------------------------

    def supports_drop_connect(self) -> bool:
        return True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        params = self.maybe_drop_connect(params, train=train, rng=rng)
        return self._hidden_mean(params, x), state

    # -- CD-k ---------------------------------------------------------------

    def gibbs_chain(self, params, v0, rng):
        """``k`` alternating Gibbs steps from ``v0``, outside autograd;
        returns the chain's last visible sample (the negative phase)."""
        with torch.no_grad():
            v, key = v0, rng
            for _ in range(self.k):
                key, kh, kv = random.split(key, 3)
                h = self._sample_hidden(params, v, kh)
                v = self._sample_visible(params, h, kv)
        return v

    def pretrain_loss(self, params, x, rng):
        if rng is None:
            rng = random.host_key(0)
        v_neg = self.gibbs_chain(params, x, rng)
        cd = torch.mean(self._pseudo_energy(params, x)
                        - self._pseudo_energy(params, v_neg))
        # the monitor term, of zero gradient: the reconstruction error,
        # the quantity the reference reports as the RBM's score
        with torch.no_grad():
            recon = self._visible_mean(params, self._hidden_mean(params, x))
            err = torch.mean(torch.sum((recon - x) ** 2, dim=-1))
        return cd + (err - cd.detach())

    def reconstruction_error(self, params, x):
        recon = self._visible_mean(params, self._hidden_mean(params, x))
        return torch.mean(torch.sum((recon - x) ** 2, dim=-1))
