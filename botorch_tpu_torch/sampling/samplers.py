r"""MC samplers (counterpart of `botorch_tpu/sampling/samplers.py`): each
is a recipe for base samples matched to a posterior's
`base_sample_shape`, pushed through `rsample_from_base_samples`.

The Sample-Average-Approximation contract is carried by explicit
base-sample tensors, drawn once and held by the acquisition function
(`acquisition/monte_carlo.py`). Every random draw comes from an explicit
`torch.Generator` on the posterior's device.

`IndexSampler` draws indices into an ensemble posterior's leading dim.
The two pairwise samplers come with the slice whose models need them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from botorch_tpu_torch.sampling.sobol import draw_sobol_normal_samples
from botorch_tpu_torch.settings import make_generator, resolve_device

Tensor = torch.Tensor

# Sobol base samples up to this many dims (scipy's Joe-Kuo table), i.i.d. above
_SOBOL_MAX_DIM = 1111


@dataclass(frozen=True)
class IIDNormalSampler:
    """i.i.d. standard-normal base samples from a generator seeded with
    `seed`."""

    sample_shape: tuple = (128,)
    seed: int = 0

    def base_samples(self, shape: tuple, device=None, dtype=torch.float32) -> Tensor:
        """`(*sample_shape, *shape)` draws on `device` (CUDA unless given)."""
        device = resolve_device(device)
        gen = make_generator(self.seed, device)
        return torch.randn((*self.sample_shape, *shape), generator=gen, dtype=dtype,
                           device=device)

    def __call__(self, posterior) -> Tensor:
        return posterior.rsample_from_base_samples(
            self.base_samples(posterior.base_sample_shape, device=posterior.mean.device)
        )


@dataclass(frozen=True)
class SobolQMCNormalSampler:
    """Scrambled-Sobol qMC normal base samples, low-discrepancy over the
    flattened event dims: the variance-reduction default of the MC
    acquisitions."""

    sample_shape: tuple = (128,)
    seed: int = 0

    def base_samples(self, shape: tuple, device=None) -> Tensor:
        """`(*sample_shape, *shape)` normals on `device` (CUDA unless given)."""
        z = draw_sobol_normal_samples(
            d=math.prod(shape), n=math.prod(self.sample_shape), seed=self.seed, device=device
        )
        return z.reshape(*self.sample_shape, *shape)

    def __call__(self, posterior) -> Tensor:
        return posterior.rsample_from_base_samples(
            self.base_samples(posterior.base_sample_shape, device=posterior.mean.device)
        )


@dataclass(frozen=True)
class StochasticSampler:
    """Fresh draws on every call, for stochastic-gradient optimization of
    an acquisition. Without a `generator` it draws from one seeded with 0."""

    sample_shape: tuple = (128,)

    def __call__(self, posterior, generator: Optional[torch.Generator] = None) -> Tensor:
        if generator is None:
            generator = make_generator(0, posterior.mean.device)
        return posterior.rsample(generator, self.sample_shape)


@dataclass(frozen=True)
class ForkedRNGSampler:
    """Draws from a generator seeded with `seed` on every call: the same
    seed gives the same samples, but not through fixed base samples."""

    sample_shape: tuple = (128,)
    seed: int = 0

    def __call__(self, posterior) -> Tensor:
        gen = make_generator(self.seed, posterior.mean.device)
        return posterior.rsample(gen, self.sample_shape)


@dataclass(frozen=True)
class ListSampler:
    """One sampler per posterior of a list (model-list posteriors)."""

    samplers: tuple = ()

    def __call__(self, posteriors: Sequence) -> list:
        return [s(p) for s, p in zip(self.samplers, posteriors)]


@dataclass(frozen=True)
class IndexSampler:
    """Ensemble index draws: the base sample is an index into the
    posterior's leading ensemble dim, and a sample is that member's mean
    (each member taken as a point mass). `weights (S,)`, if given, biases
    the draw as categorical probabilities. The JAX package's debug-mode
    check that the members have no variance is not ported (its `settings`
    flags are ROADMAP item 20)."""

    sample_shape: tuple = (128,)
    seed: int = 0
    weights: Optional[Tensor] = None

    def indices(self, ensemble_size: int, device=None) -> Tensor:
        """`sample_shape` indices in `[0, ensemble_size)` on `device` (CUDA
        unless given), from a generator seeded with `seed`."""
        device = resolve_device(device)
        gen = make_generator(self.seed, device)
        n = math.prod(self.sample_shape)
        if self.weights is not None:
            w = torch.as_tensor(self.weights, device=device)
            idx = torch.multinomial(w, n, replacement=True, generator=gen)
        else:
            idx = torch.randint(0, ensemble_size, (n,), generator=gen, device=device)
        return idx.reshape(self.sample_shape)

    def __call__(self, posterior, indices: Optional[Tensor] = None) -> Tensor:
        """`(*sample_shape, ..., q, m)` member means; `indices` replaces the
        draw."""
        mean = posterior.mean  # (S, ..., q, m)
        if indices is None:
            indices = self.indices(mean.shape[0], device=mean.device)
        indices = torch.as_tensor(indices, device=mean.device)
        return mean[indices]


def get_sampler(posterior, sample_shape: tuple, seed: int = 0):
    """Sobol qMC when the base-sample dimension is within the Sobol table,
    i.i.d. normal otherwise."""
    if math.prod(posterior.base_sample_shape) <= _SOBOL_MAX_DIM:
        return SobolQMCNormalSampler(sample_shape=sample_shape, seed=seed)
    return IIDNormalSampler(sample_shape=sample_shape, seed=seed)
