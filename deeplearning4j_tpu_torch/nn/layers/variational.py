"""The variational autoencoder layer and its reconstruction distributions.

Counterpart of ``deeplearning4j_tpu/nn/layers/variational.py``. The
negative ELBO (encoder, reparameterised sample, decoder, the
reconstruction's negative log-likelihood, ``KL(q(z|x) || N(0, I))``) is
one differentiable function, autograd its backward; every product is
plain PyTorch, as it is plain XLA in the JAX package. JAX draws
``num_samples`` samples under ``vmap`` over ``split(rng,
num_samples)``; here a loop over the same keys, each noise draw
``nn/random.py``'s ``normal`` (JAX's samples to within its ``erfinv``).
The distributions are frozen dataclasses registered by class name
(``register_distribution``), tagged ``@dist_class`` in a layer's JSON,
as the JAX package writes them. In a supervised net ``apply`` returns
the activated mean of q(z|x).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import random
from deeplearning4j_tpu_torch.nn.layers.base import (
    FeedForwardLayerSpec,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights

_DISTRIBUTION_REGISTRY: dict = {}


def register_distribution(cls):
    _DISTRIBUTION_REGISTRY[cls.__name__] = cls
    return cls


@dataclass(frozen=True)
class ReconstructionDistribution:
    """A family p(x|z) (reference ``ReconstructionDistribution``)."""

    activation: str = "identity"

    def param_size(self, data_size: int) -> int:
        """Decoder outputs a data column needs (reference
        ``distributionInputSize``)."""
        raise NotImplementedError

    def neg_log_prob(self, x, preout) -> torch.Tensor:
        """Per-example ``-log p(x|z)``: [batch] from x [batch, d] and the
        raw decoder output [batch, param_size(d)]."""
        raise NotImplementedError

    def generate_at_mean(self, preout) -> torch.Tensor:
        raise NotImplementedError

    def generate_random(self, rng, preout) -> torch.Tensor:
        raise NotImplementedError

    def to_json(self) -> dict:
        d = {"@dist_class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "components":
                v = [[s, c.to_json()] for s, c in v]
            d[f.name] = v
        return d

    @staticmethod
    def from_json(d: dict) -> "ReconstructionDistribution":
        d = dict(d)
        cls = _DISTRIBUTION_REGISTRY[d.pop("@dist_class")]
        if cls is CompositeReconstructionDistribution:
            return cls(components=tuple(
                (int(s), ReconstructionDistribution.from_json(c))
                for s, c in d.get("components", [])))
        return cls(**d)


@register_distribution
@dataclass(frozen=True)
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """p(x|z) = Bernoulli(act(preout)); with the sigmoid, the stable
    cross-entropy on the logits."""

    activation: str = "sigmoid"

    def param_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob(self, x, preout) -> torch.Tensor:
        if self.activation == "sigmoid":
            nll = (torch.clamp_min(preout, 0.0) - preout * x
                   + torch.log1p(torch.exp(-torch.abs(preout))))
        else:
            p = torch.clamp(activations.get(self.activation)(preout), 1e-7,
                            1 - 1e-7)
            nll = -(x * torch.log(p) + (1 - x) * torch.log1p(-p))
        return torch.sum(nll, dim=-1)

    def generate_at_mean(self, preout) -> torch.Tensor:
        return activations.get(self.activation)(preout)

    def generate_random(self, rng, preout) -> torch.Tensor:
        p = activations.get(self.activation)(preout)
        return random.bernoulli(rng, p).to(preout.dtype)


@register_distribution
@dataclass(frozen=True)
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """p(x|z) = N(mean, diag(σ²)); the decoder gives [mean, log σ²]."""

    def param_size(self, data_size: int) -> int:
        return 2 * data_size

    def _split(self, preout):
        d = preout.shape[-1] // 2
        act = activations.get(self.activation)
        return act(preout[..., :d]), preout[..., d:]

    def neg_log_prob(self, x, preout) -> torch.Tensor:
        mean, log_var = self._split(preout)
        log_var = torch.clamp(log_var, -10.0, 10.0)
        nll = 0.5 * (math.log(2 * math.pi) + log_var
                     + (x - mean) ** 2 / torch.exp(log_var))
        return torch.sum(nll, dim=-1)

    def generate_at_mean(self, preout) -> torch.Tensor:
        return self._split(preout)[0]

    def generate_random(self, rng, preout) -> torch.Tensor:
        mean, log_var = self._split(preout)
        std = torch.exp(0.5 * torch.clamp(log_var, -10.0, 10.0))
        eps = random.normal(rng, mean.shape, device=mean.device)
        return mean + std * eps.to(mean.dtype)


@register_distribution
@dataclass(frozen=True)
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """p(x|z) = Exp(λ), λ = exp(γ), γ = act(preout) clipped to ±20:
    ``-log p = λx - γ``."""

    def param_size(self, data_size: int) -> int:
        return data_size

    def _gamma(self, preout):
        return torch.clamp(activations.get(self.activation)(preout),
                           -20.0, 20.0)

    def neg_log_prob(self, x, preout) -> torch.Tensor:
        gamma = self._gamma(preout)
        return torch.sum(torch.exp(gamma) * x - gamma, dim=-1)

    def generate_at_mean(self, preout) -> torch.Tensor:
        return torch.exp(-self._gamma(preout))  # 1 / λ

    def generate_random(self, rng, preout) -> torch.Tensor:
        u = random.uniform(rng, preout.shape, device=preout.device,
                           minval=1e-7, maxval=1.0).to(preout.dtype)
        return -torch.log(u) * torch.exp(-self._gamma(preout))


@register_distribution
@dataclass(frozen=True)
class LossFunctionWrapper(ReconstructionDistribution):
    """A loss function as a pseudo distribution: the VAE becomes a
    regularised autoencoder."""

    loss: str = "MSE"

    def param_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob(self, x, preout) -> torch.Tensor:
        return losses_mod.per_row_scores(self.loss, x, preout,
                                         self.activation)

    def generate_at_mean(self, preout) -> torch.Tensor:
        return activations.get(self.activation)(preout)

    def generate_random(self, rng, preout) -> torch.Tensor:
        return self.generate_at_mean(preout)


@register_distribution
@dataclass(frozen=True)
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Distributions over slices of the data vector; ``components`` is a
    tuple of ``(data_size, distribution)``. Component i draws from
    ``fold_in(rng, i)``."""

    components: Tuple[Tuple[int, ReconstructionDistribution], ...] = ()

    def param_size(self, data_size: int) -> int:
        total = sum(s for s, _ in self.components)
        if total != data_size:
            raise ValueError(f"Composite component sizes sum to {total}, "
                             f"but data size is {data_size}")
        return sum(d.param_size(s) for s, d in self.components)

    def _slices(self):
        xo = po = 0
        for s, d in self.components:
            ps = d.param_size(s)
            yield xo, s, po, ps, d
            xo += s
            po += ps

    def neg_log_prob(self, x, preout) -> torch.Tensor:
        total = 0.0
        for xo, s, po, ps, d in self._slices():
            total = total + d.neg_log_prob(x[..., xo:xo + s],
                                           preout[..., po:po + ps])
        return total

    def generate_at_mean(self, preout) -> torch.Tensor:
        return torch.cat([d.generate_at_mean(preout[..., po:po + ps])
                          for _, _, po, ps, d in self._slices()], dim=-1)

    def generate_random(self, rng, preout) -> torch.Tensor:
        return torch.cat([
            d.generate_random(random.fold_in(rng, i),
                              preout[..., po:po + ps])
            for i, (_, _, po, ps, d) in enumerate(self._slices())], dim=-1)


@register_layer
@dataclass(frozen=True)
class VariationalAutoencoder(FeedForwardLayerSpec):
    """Variational autoencoder (reference ``VariationalAutoencoder``).
    ``n_out`` is the latent size. Parameters as the reference names
    them: ``eW{i}``/``eb{i}`` the encoder, ``pZXMeanW``/``b`` and
    ``pZXLogStd2W``/``b`` the posterior's heads, ``dW{i}``/``db{i}`` the
    decoder, ``pXZW``/``b`` the reconstruction head."""

    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    pzx_activation: str = "identity"
    reconstruction_distribution: ReconstructionDistribution = (
        BernoulliReconstructionDistribution())
    num_samples: int = 1

    def is_pretrainable(self) -> bool:
        return True

    def regularizable_params(self) -> tuple:
        names = ["pZXMeanW", "pZXLogStd2W", "pXZW"]
        names += [f"eW{i}" for i in range(len(self.encoder_layer_sizes))]
        names += [f"dW{i}" for i in range(len(self.decoder_layer_sizes))]
        return tuple(names)

    def _shapes(self):
        recon = self.reconstruction_distribution.param_size(self.n_in)
        shapes, prev = [], self.n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            shapes.append((f"eW{i}", f"eb{i}", prev, h))
            prev = h
        shapes.append(("pZXMeanW", "pZXMeanb", prev, self.n_out))
        shapes.append(("pZXLogStd2W", "pZXLogStd2b", prev, self.n_out))
        prev = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            shapes.append((f"dW{i}", f"db{i}", prev, h))
            prev = h
        shapes.append(("pXZW", "pXZb", prev, recon))
        return shapes

    def init_params(self, gen, dtype=torch.float32) -> dict:
        params = {}
        for wn, bn, fi, fo in self._shapes():
            params[wn] = init_weights(
                gen, (fi, fo), self.weight_init, fan_in=fi, fan_out=fo,
                distribution=self.dist, dtype=dtype)
            params[bn] = torch.full((fo,), float(self.bias_init),
                                    dtype=dtype)
        return params

    # -- the sub-stacks -----------------------------------------------------

    def _encode(self, params, x):
        act = self.activate_fn()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        mean = activations.get(self.pzx_activation)(
            h @ params["pZXMeanW"] + params["pZXMeanb"])
        log_var = h @ params["pZXLogStd2W"] + params["pZXLogStd2b"]
        return mean, torch.clamp(log_var, -10.0, 10.0)

    def _decode(self, params, z):
        act = self.activate_fn()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["pXZW"] + params["pXZb"]  # the distribution's

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        return self._encode(params, x)[0], state

    # -- the negative ELBO --------------------------------------------------

    @staticmethod
    def _kl(mean, log_var):
        return 0.5 * torch.sum(torch.exp(log_var) + mean ** 2 - 1.0
                               - log_var, dim=-1)

    def _sampled_nll(self, params, x, mean, log_var, rng, n: int):
        """The reconstruction's nll averaged over ``n`` reparameterised
        samples, sample i's noise drawn from ``split(rng, n)[i]``."""
        std = torch.exp(0.5 * log_var)
        nlls = []
        for k in random.split(rng, n):
            eps = random.normal(k, mean.shape, device=mean.device)
            z = mean + std * eps.to(mean.dtype)
            nlls.append(self.reconstruction_distribution.neg_log_prob(
                x, self._decode(params, z)))
        return torch.mean(torch.stack(nlls), dim=0)

    def pretrain_loss(self, params, x, rng):
        """The batch's mean negative ELBO: ``E_q[-log p(x|z)]`` (Monte
        Carlo over ``num_samples``; without a key, at the posterior's
        mean) plus ``KL(q(z|x) || N(0, I))``."""
        mean, log_var = self._encode(params, x)
        if rng is None:
            recon = self.reconstruction_distribution.neg_log_prob(
                x, self._decode(params, mean))
        else:
            recon = self._sampled_nll(params, x, mean, log_var, rng,
                                      self.num_samples)
        return torch.mean(recon + self._kl(mean, log_var))

    # -- generation and scoring ---------------------------------------------

    def reconstruction_probability(self, params, x, rng, num_samples=None):
        """Per-example ``-log p(x)`` estimate (the reference's
        ``reconstructionLogProbability`` with its sign flipped): the
        sampled reconstruction nll plus the KL term."""
        mean, log_var = self._encode(params, x)
        n = num_samples or self.num_samples
        return (self._sampled_nll(params, x, mean, log_var, rng, n)
                + self._kl(mean, log_var))

    def generate_at_mean_given_z(self, params, z):
        return self.reconstruction_distribution.generate_at_mean(
            self._decode(params, z))

    def generate_random_given_z(self, params, z, rng):
        return self.reconstruction_distribution.generate_random(
            rng, self._decode(params, z))
