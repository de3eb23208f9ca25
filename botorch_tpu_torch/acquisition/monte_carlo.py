r"""Monte-Carlo (quasi-MC, SAA) acquisition functions (counterpart of
`botorch_tpu/acquisition/monte_carlo.py`): qEI, qLogEI, qPI,
qSimpleRegret, qUCB, qNEI and qLogNEI.

Each is a frozen dataclass holding the fitted model, its train cache
(`model.train_chol()`) and fixed qMC base samples: drawn once, they make
the acquisition surface deterministic and differentiable (the Sample
Average Approximation). `__call__` follows BoTorch's t-batch contract,
where the JAX package maps an acquisition of one `(q, d)` candidate set
with `vmap`: `X: (b, q, d)` gives values `(b,)`, samples are
`(nmc, b, q, m)`, and one base-sample block `(nmc, q_total, m)` is shared
by every t-batch element. Nothing reduces across the t-batch: each element
is computed as the JAX package computes its candidate set alone.

For qNEI and qLogNEI the joint posterior over `(X_baseline, X)` gives the
per-sample incremental best over the baseline; `baseline_mask` excludes
the padded rows of the BO loop's fixed-size buffers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, ClassVar, Optional, Union

import torch

from botorch_tpu_torch.models.gp import SingleTaskGP
from botorch_tpu_torch.sampling.sobol import (
    bits_to_unit,
    draw_sobol_bits,
    draw_sobol_normal_samples,
    sobol_table,
)
from botorch_tpu_torch.utils import safe_math as sm
from botorch_tpu_torch.utils.constraints import smoothed_feasibility_log_indicator
from botorch_tpu_torch.utils.transforms import is_fully_bayesian

Tensor = torch.Tensor

TAU_RELU = 1e-6
TAU_MAX = 1e-2
DEFAULT_MC_SAMPLES = 512


def _reduce(val: Tensor, batch_ndim: int, log: bool = False) -> Tensor:
    """Reduce the dims after the `batch_ndim` t-batch dims (ensemble dims):
    mean, or logmeanexp for log values. The t-batch dims stay."""
    dims = tuple(range(batch_ndim, val.ndim))
    if not dims:
        return val
    return sm.logmeanexp(val, dim=dims) if log else torch.mean(val, dim=dims)


def identity_objective(samples: Tensor) -> Tensor:
    """Default MC objective: the first output."""
    return samples[..., 0]


def linear_objective(weights) -> Callable[[Tensor], Tensor]:
    """`sum_m w_m y_m` of each sample."""

    def obj(samples: Tensor) -> Tensor:
        w = torch.as_tensor(weights, dtype=samples.dtype, device=samples.device)
        return torch.sum(samples * w, dim=-1)

    return obj


@dataclass(frozen=True, kw_only=True)
class MCAcquisitionFunction:
    """Base: model, cached train root and fixed qMC base samples
    `(num_mc, q_total, m)`, where `q_total = q` (+ pending points, + the
    baseline for the noisy variants)."""

    model: SingleTaskGP
    cache: tuple  # model.train_chol()
    base_samples: Tensor
    objective: Callable = identity_objective
    constraints: tuple = ()
    eta: float = 1e-3
    X_pending: Optional[Tensor] = None

    # fat-tailed smooth feasibility in `_log_feas` (the log variants)
    _fat: ClassVar[bool] = False

    def _with_pending(self, X: Tensor) -> Tensor:
        if self.X_pending is None:
            return X
        pending = self.X_pending.expand(*X.shape[:-2], *self.X_pending.shape[-2:])
        return torch.cat([X, pending], dim=-2)

    def _samples_and_obj(self, X: Tensor) -> tuple[Tensor, Tensor]:
        """Posterior samples `(nmc, *batch, q, m)` and objective values
        `(nmc, *batch, q)` at `X (*batch, q, d)`; the base samples are
        shared by every batch element."""
        post = self.model.posterior(X, cache=self.cache)
        nmc, q, m = self.base_samples.shape
        base = self.base_samples.reshape(nmc, *([1] * len(post.batch_shape)), q, m)
        samples = post.rsample_from_base_samples(base)
        if getattr(self.objective, "needs_X", False):
            # point-dependent objectives receive the candidate set too
            return samples, self.objective(samples, X)
        return samples, self.objective(samples)

    def _log_feas(self, samples: Tensor) -> Tensor:
        if not self.constraints:
            return torch.zeros(samples.shape[:-1], dtype=samples.dtype, device=samples.device)
        return smoothed_feasibility_log_indicator(
            self.constraints, samples, self.eta, fat=self._fat
        )

    def _feas(self, samples: Tensor) -> Tensor:
        """The (non-fat) smooth feasibility weight of each sample point."""
        return torch.exp(
            smoothed_feasibility_log_indicator(self.constraints, samples, self.eta, fat=False)
        )


# ------------------------------------------------------------------------- #
@dataclass(frozen=True, kw_only=True)
class qExpectedImprovement(MCAcquisitionFunction):
    """`qEI(X) = E[max_q relu(obj - best_f)]`."""

    best_f: Union[Tensor, float] = 0.0

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        samples, obj = self._samples_and_obj(X)
        imp = sm.maximum(obj - self.best_f, 0.0)
        if self.constraints:
            imp = imp * self._feas(samples)
        return _reduce(torch.mean(torch.amax(imp, dim=-1), dim=0), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qLogExpectedImprovement(MCAcquisitionFunction):
    """`qLogEI(X) = logmeanexp_s fatmax_q log_fatplus((obj - best_f)/tau)`
    [Ament2023logei]: log-EI values."""

    best_f: Union[Tensor, float] = 0.0
    tau_relu: float = TAU_RELU
    tau_max: float = TAU_MAX
    _fat: ClassVar[bool] = True

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        samples, obj = self._samples_and_obj(X)
        li = sm.log_fatplus(obj - self.best_f, tau=self.tau_relu)
        li = li + self._log_feas(samples)
        return _reduce(
            sm.logmeanexp(sm.fatmax(li, dim=-1, tau=self.tau_max), dim=0), X.ndim - 2, log=True
        )


@dataclass(frozen=True, kw_only=True)
class qProbabilityOfImprovement(MCAcquisitionFunction):
    """`qPI` with a sigmoid-smoothed improvement indicator."""

    best_f: Union[Tensor, float] = 0.0
    tau: float = 1e-3

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        samples, obj = self._samples_and_obj(X)
        val = torch.sigmoid((obj - self.best_f) / self.tau)
        if self.constraints:
            val = val * self._feas(samples)
        return _reduce(torch.mean(torch.amax(val, dim=-1), dim=0), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qSimpleRegret(MCAcquisitionFunction):
    """`E[max_q obj]`."""

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        _, obj = self._samples_and_obj(X)
        return _reduce(torch.mean(torch.amax(obj, dim=-1), dim=0), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qUpperConfidenceBound(MCAcquisitionFunction):
    """`E[max_q (mu + sqrt(beta pi / 2) |y - mu|)]`."""

    beta: float = 0.25

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        _, obj = self._samples_and_obj(X)
        post = self.model.posterior(X, cache=self.cache)
        mean = self.objective(post.mean)  # (*batch, q), broadcasts against obj
        ucb = mean + math.sqrt(self.beta * math.pi / 2.0) * torch.abs(obj - mean)
        return _reduce(torch.mean(torch.amax(ucb, dim=-1), dim=0), X.ndim - 2)


# ------------------------------------------------------------------------- #
@dataclass(frozen=True, kw_only=True)
class _NoisyMixin(MCAcquisitionFunction):
    """Joint (baseline, candidate) evaluation with the per-sample best over
    the baseline. `baseline_mask (nb,)` marks the real rows of a padded
    baseline; the others take no part in the best."""

    X_baseline: Tensor
    baseline_mask: Optional[Tensor] = None

    def _joint_obj(self, X: Tensor):
        nb = self.X_baseline.shape[-2]
        batch = X.shape[:-2]
        X_full = torch.cat([self.X_baseline.expand(*batch, *self.X_baseline.shape[-2:]), X],
                           dim=-2)
        samples, obj = self._samples_and_obj(X_full)
        obj_base, obj_new = obj[..., :nb], obj[..., nb:]
        samples_new = samples[..., nb:, :]
        if self.constraints:
            feas = smoothed_feasibility_log_indicator(
                self.constraints, samples[..., :nb, :], self.eta, fat=self._fat
            )
            # hard-gate infeasible baseline points to -inf before the max
            obj_base = torch.where(feas > math.log(0.5), obj_base, -torch.inf)
        if self.baseline_mask is not None:
            obj_base = torch.where(self.baseline_mask, obj_base, -torch.inf)
        best_f = torch.amax(obj_base, dim=-1, keepdim=True)
        # a sample without a finite best takes the smallest objective value
        # of its candidate set's samples and baseline points
        lowest = torch.amin(obj_base, dim=-1, keepdim=True).amin(dim=0, keepdim=True)
        best_f = torch.where(torch.isfinite(best_f), best_f, lowest)
        return samples_new, obj_new, best_f


@dataclass(frozen=True, kw_only=True)
class qNoisyExpectedImprovement(_NoisyMixin):
    """`qNEI`: improvement over the per-sample best of the noisy baseline."""

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        samples_new, obj_new, best_f = self._joint_obj(X)
        imp = sm.maximum(obj_new - best_f, 0.0)
        if self.constraints:
            imp = imp * self._feas(samples_new)
        return _reduce(torch.mean(torch.amax(imp, dim=-1), dim=0), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qLogNoisyExpectedImprovement(_NoisyMixin):
    """`qLogNEI`: log of the smoothed noisy expected improvement."""

    tau_relu: float = TAU_RELU
    tau_max: float = TAU_MAX
    _fat: ClassVar[bool] = True

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        samples_new, obj_new, best_f = self._joint_obj(X)
        li = sm.log_fatplus(obj_new - best_f, tau=self.tau_relu)
        li = li + self._log_feas(samples_new)
        return _reduce(
            sm.logmeanexp(sm.fatmax(li, dim=-1, tau=self.tau_max), dim=0), X.ndim - 2, log=True
        )


# ------------------------------------------------------------------------- #
def _draw_base_samples(q_total: int, m: int, num_samples: int, seed, device=None) -> Tensor:
    z = draw_sobol_normal_samples(q_total * m, num_samples, seed=seed, device=device)
    return z.reshape(num_samples, q_total, m)


def base_samples_from_words(
    q_total: int, m: int, num_samples: int, words: Tensor, seed: int = 0
) -> Tensor:
    """float32 qMC N(0, 1) base samples `(num_samples, q_total, m)` of the
    scrambled Sobol engine seeded with `seed`, its digital shift XORed with
    the 32-bit `words (q_total * m,)`."""
    sv, shift = sobol_table(q_total * m, scramble=True, seed=seed, device=words.device)
    bits = draw_sobol_bits(sv, shift ^ words.to(torch.int64), num_samples)
    z = torch.special.ndtri(bits_to_unit(bits, dtype=torch.float32))
    return z.reshape(num_samples, q_total, m)


def draw_fresh_base_samples(
    q_total: int, m: int, num_samples: int, generator: torch.Generator, seed: int = 0
) -> Tensor:
    """qMC N(0, 1) base samples re-randomized by `generator`: the digital
    shift of the seeded Sobol engine is XORed with fresh random words, so
    every BO iteration gets an independent low-discrepancy draw, fixed for
    the acquisition instance (the SAA determinism the optimizer needs)."""
    words = torch.randint(0, 1 << 32, (q_total * m,), generator=generator,
                          dtype=torch.int64, device=generator.device)
    return base_samples_from_words(q_total, m, num_samples, words, seed=seed)


def make_mc_acqf(
    cls,
    model: SingleTaskGP,
    q: int,
    num_samples: int = DEFAULT_MC_SAMPLES,
    seed: int = 0,
    X_pending: Optional[Tensor] = None,
    prune_baseline: bool = False,
    **kwargs,
):
    """An MC acquisition with the model's train cache and qMC base samples
    over `q` (+ pending, + baseline) points. For the noisy variants pass
    `X_baseline=`."""
    if is_fully_bayesian(model):
        raise NotImplementedError(
            "MC acquisition over a fully-Bayesian ensemble is not ported: the t-batch "
            "reduction, scale_tril's batch dims and the noisy fallback min do not carry "
            "the ensemble dim yet (ROADMAP item 14a, the follow-up of item 14)"
        )
    if prune_baseline and kwargs.get("X_baseline") is not None:
        raise NotImplementedError(
            "prune_baseline needs acquisition/utils.prune_inferior_points, which comes "
            "with the acquisition-breadth slice (ROADMAP item 19)"
        )
    q_total = q
    if X_pending is not None:
        q_total += X_pending.shape[-2]
    if kwargs.get("X_baseline") is not None:
        q_total += kwargs["X_baseline"].shape[-2]
    base = _draw_base_samples(q_total, model.num_outputs, num_samples, seed,
                              device=model.X.device)
    return cls(model=model, cache=model.train_chol(), base_samples=base,
               X_pending=X_pending, **kwargs)
