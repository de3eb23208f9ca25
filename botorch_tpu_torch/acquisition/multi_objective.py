r"""Multi-objective MC acquisition functions: q(Log)EHVI and q(Log)NEHVI
(counterpart of `botorch_tpu/acquisition/multi_objective.py`), for two
objectives.

The hypervolume improvement of a q-batch is computed per MC sample by
inclusion-exclusion over the `2^q - 1` non-empty subsets of the candidates
against a box decomposition of the region the front does not dominate.
The subset masks are fixed by q, so the whole computation is one batched
reduction.

qNEHVI decomposes the front of each MC sample of the noisy baseline: the
2-d staircase cells are built for all samples at once. The baseline block
of the SAA samples does not depend on the candidates, so `make_qnehvi` and
the MO loop build the cells once per acquisition (`make_in_graph_nehvi_cells`)
instead of at every evaluation.

The log variants smooth the cell overlaps with the fat-tailed softplus and
take the log of the aggregated improvement.

As everywhere in the port, `__call__` takes a t-batch `X (b, q, d)` and
returns `(b,)`, where the JAX package maps one candidate set at a time:
the reductions run over the MC samples only, and the precomputed cells
`(nmc, C, m)` broadcast over the t-batch. The m >= 3 decompositions come
with ROADMAP item 15b.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import ClassVar, Optional

import torch

from botorch_tpu_torch.acquisition.monte_carlo import (
    DEFAULT_MC_SAMPLES,
    MCAcquisitionFunction,
    _draw_base_samples,
    _reduce,
    smoothed_feasibility_log_indicator,
)
from botorch_tpu_torch.models.gp import SingleTaskGP
from botorch_tpu_torch.utils import safe_math as sm
from botorch_tpu_torch.utils.multi_objective import (
    is_non_dominated,
    nondominated_hypercell_bounds_2d,
)
from botorch_tpu_torch.utils.transforms import is_fully_bayesian

Tensor = torch.Tensor

CLIP_MAX = 1e8


def _subset_masks(q: int, device=None) -> tuple[Tensor, Tensor]:
    """`(2^q - 1, q)` boolean masks of the non-empty subsets of q
    candidates, by size then lexicographically, and their
    inclusion-exclusion signs `(2^q - 1,)`."""
    masks, signs = [], []
    for r in range(1, q + 1):
        for comb in itertools.combinations(range(q), r):
            masks.append([i in comb for i in range(q)])
            signs.append((-1.0) ** (r + 1))
    return (torch.tensor(masks, dtype=torch.bool, device=device),
            torch.tensor(signs, dtype=torch.float32, device=device))


def _hvi_from_cells(
    F: Tensor,  # (..., q, m) objective samples of the candidates
    cell_lower: Tensor,  # (..., C, m)
    cell_upper: Tensor,  # (..., C, m)
    masks: Tensor,  # (S, q)
    signs: Tensor,  # (S,)
    smooth_tau: float = 0.0,
) -> Tensor:
    """Inclusion-exclusion hypervolume improvement, batched:
    `HVI = sum_c sum_S sign_S prod_j [min(min_{i in S} F_ij, u_cj) - l_cj]^+`.

    The subset-min takes `+inf` at the candidates outside a subset and
    splits its gradient evenly among ties (`torch.amin`), as `jnp.min` does."""
    big = torch.zeros(masks.shape, dtype=F.dtype, device=F.device).masked_fill(~masks, math.inf)
    Fmin = torch.amin(F[..., None, :, :] + big[:, :, None], dim=-2)  # (..., S, m)
    capped = torch.minimum(Fmin[..., :, None, :], cell_upper[..., None, :, :])
    edge = capped - cell_lower[..., None, :, :]  # (..., S, C, m)
    if smooth_tau > 0:
        edge = sm.fatplus(edge, tau=smooth_tau)
    else:
        edge = sm.maximum(edge, 0.0)
    vol = torch.prod(edge, dim=-1)  # (..., S, C)
    return torch.sum(signs.to(vol.dtype)[..., :, None] * vol, dim=(-1, -2))


def _log_mean(hvi: Tensor, batch_ndim: int) -> Tensor:
    """`logmeanexp` of `log max(hvi, 1e-30)` over the MC dim and any dims
    after the t-batch."""
    log_hvi = torch.log(sm.maximum(hvi, 1e-30))
    return _reduce(sm.logmeanexp(log_hvi, dim=0), batch_ndim, log=True)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True, kw_only=True)
class qExpectedHypervolumeImprovement(MCAcquisitionFunction):
    """qEHVI over a fixed decomposition `(C, m)` of the current
    non-dominated region."""

    ref_point: Tensor
    cell_lower: Tensor  # (C, m)
    cell_upper: Tensor
    masks: Tensor
    signs: Tensor
    smooth_tau: float = 0.0

    def _hvi(self, X: Tensor) -> Tensor:
        samples, _ = self._samples_and_obj(X)  # (nmc, *batch, q, m)
        if self.constraints:
            # feasibility-weight each candidate: infeasible samples move to
            # the reference point (zero improvement)
            feas = smoothed_feasibility_log_indicator(
                self.constraints, samples, self.eta, fat=self._fat
            )
            w = torch.exp(feas)[..., None]
            samples = self.ref_point + w * (samples - self.ref_point)
        return _hvi_from_cells(
            samples, self.cell_lower, self.cell_upper, self.masks, self.signs,
            smooth_tau=self.smooth_tau,
        )

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        return _reduce(torch.mean(self._hvi(X), dim=0), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qLogExpectedHypervolumeImprovement(qExpectedHypervolumeImprovement):
    """log qEHVI with fat-tailed smoothing of the cell overlaps."""

    smooth_tau: float = 1e-3
    _fat: ClassVar[bool] = True

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        return _log_mean(self._hvi(X), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qNoisyExpectedHypervolumeImprovement(MCAcquisitionFunction):
    """qNEHVI: the HVI against the box decomposition of each MC sample's
    front of the noisy baseline.

    `cell_lower/cell_upper (nmc, C, m)`, when given, are those per-sample
    cells built once from the baseline block of the base samples (they
    broadcast over the t-batch); else the cells are built at each
    evaluation. `baseline_mask (nb,)` marks the real rows of a padded
    baseline: the others move strictly below the reference point, so they
    add no cell.
    """

    X_baseline: Tensor
    ref_point: Tensor
    masks: Tensor
    signs: Tensor
    cell_lower: Optional[Tensor] = None
    cell_upper: Optional[Tensor] = None
    baseline_mask: Optional[Tensor] = None
    smooth_tau: float = 0.0

    def _joint_samples(self, X: Tensor):
        nb = self.X_baseline.shape[-2]
        X_base = self.X_baseline.expand(*X.shape[:-2], *self.X_baseline.shape[-2:])
        samples, _ = self._samples_and_obj(torch.cat([X_base, X], dim=-2))
        return samples[..., :nb, :], samples[..., nb:, :]

    def _hvi(self, X: Tensor) -> Tensor:
        base_samples, cand_samples = self._joint_samples(X)
        if self.baseline_mask is not None:
            base_samples = torch.where(
                self.baseline_mask[..., :, None], base_samples, self.ref_point - 1.0
            )
        if self.constraints:
            feas_b = smoothed_feasibility_log_indicator(
                self.constraints, base_samples, self.eta, fat=self._fat
            )
            base_samples = torch.where(
                (feas_b > math.log(0.5))[..., None], base_samples, self.ref_point
            )
            feas_c = smoothed_feasibility_log_indicator(
                self.constraints, cand_samples, self.eta, fat=self._fat
            )
            w = torch.exp(feas_c)[..., None]
            cand_samples = self.ref_point + w * (cand_samples - self.ref_point)
        if self.cell_lower is not None:
            if self.constraints:
                # the cells come from the unshifted baseline samples, but the
                # constrained path shifts them at every evaluation
                raise ValueError(
                    "outcome-constrained qNEHVI must not carry precomputed cells "
                    "(cell_lower); build it without them so the cells follow the "
                    "constraint-shifted baselines"
                )
            lo, up = self.cell_lower, self.cell_upper
            # broadcast the (nmc, C, m) cells over the t-batch (and ensemble) dims
            for _ in range(cand_samples.ndim - 3):
                lo, up = lo[:, None], up[:, None]
        else:
            lo, up = cells_from_baseline_samples(base_samples, self.ref_point, clip_max=CLIP_MAX)
        return _hvi_from_cells(
            cand_samples, lo, up, self.masks, self.signs, smooth_tau=self.smooth_tau
        )

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        return _reduce(torch.mean(self._hvi(X), dim=0), X.ndim - 2)


@dataclass(frozen=True, kw_only=True)
class qLogNoisyExpectedHypervolumeImprovement(qNoisyExpectedHypervolumeImprovement):
    """log qNEHVI with fat-tailed smoothing of the cell overlaps."""

    smooth_tau: float = 1e-3
    _fat: ClassVar[bool] = True

    def __call__(self, X: Tensor) -> Tensor:
        X = self._with_pending(X)
        return _log_mean(self._hvi(X), X.ndim - 2)


# --------------------------------------------------------------------------- #
def _refuse(model: SingleTaskGP, prune_baseline: bool = False) -> None:
    if is_fully_bayesian(model):
        raise NotImplementedError(
            "MC acquisition over a fully-Bayesian ensemble is not ported (ROADMAP item 14a)"
        )
    if model.num_outputs != 2:
        raise NotImplementedError(
            f"hypervolume acquisition over {model.num_outputs} objectives needs the m >= 3 "
            "box decompositions, which come with ROADMAP item 15b"
        )
    if prune_baseline:
        raise NotImplementedError(
            "prune_baseline needs acquisition/utils.prune_inferior_points_multi_objective, "
            "which comes with the acquisition-breadth slice (ROADMAP item 19)"
        )


def _n_pending(kwargs: dict) -> int:
    P = kwargs.get("X_pending")
    return 0 if P is None else P.shape[-2]


def make_qehvi(
    cls,
    model: SingleTaskGP,
    ref_point,
    q: int,
    Y_baseline: Tensor,
    num_samples: int = DEFAULT_MC_SAMPLES,
    seed: int = 0,
    **kwargs,
):
    """Build q(Log)EHVI: decompose the observed front once and fix qMC base
    samples over the q candidates (and any `X_pending`)."""
    _refuse(model)
    dev, dtype = model.X.device, model.X.dtype
    ref_point = torch.as_tensor(ref_point, dtype=dtype, device=dev)
    Y = torch.as_tensor(Y_baseline, dtype=dtype, device=dev)
    front = Y[is_non_dominated(Y)]
    front = front[(front > ref_point).all(-1)]
    if front.shape[0] > 0:
        lo, up = nondominated_hypercell_bounds_2d(front, ref_point, clip_max=CLIP_MAX)
    else:
        lo = ref_point[None, :]
        up = torch.full((1, 2), CLIP_MAX, dtype=dtype, device=dev)
    masks, signs = _subset_masks(q, device=dev)
    base = _draw_base_samples(q + _n_pending(kwargs), 2, num_samples, seed, device=dev)
    return cls(
        model=model, cache=model.train_chol(), base_samples=base, ref_point=ref_point,
        cell_lower=lo, cell_upper=up, masks=masks, signs=signs, **kwargs,
    )


def cells_from_baseline_samples(bs: Tensor, ref_point: Tensor, clip_max: float = CLIP_MAX):
    """Per-MC-sample non-dominated cells `(..., nb + 1, 2)` from baseline
    objective samples `bs (..., nb, 2)`: the batched 2-d staircase. Both
    the evaluation-time path and `make_in_graph_nehvi_cells` use it."""
    m = bs.shape[-1]
    if m != 2:
        raise NotImplementedError(
            f"per-sample cells of {m} objectives need the padded Lacour decomposition "
            "(ROADMAP item 15b)"
        )
    ref_b = torch.broadcast_to(ref_point, (m,))
    return nondominated_hypercell_bounds_2d(bs, ref_b, clip_max=clip_max)


def make_in_graph_nehvi_cells(
    model,
    cache,
    X_baseline: Tensor,
    base_prefix: Tensor,
    ref_point: Tensor,
    baseline_mask: Optional[Tensor] = None,
    clip_max: float = CLIP_MAX,
):
    """Per-MC-sample non-dominated cells of qNEHVI, built once from the
    baseline block `base_prefix (nmc, nb, m)` of the SAA base samples.

    The baseline rows of the joint samples do not depend on the candidates
    (the joint factor's top-left block is the baseline's own), so the
    decomposition is a constant of the acquisition. Only for unconstrained
    qNEHVI: outcome constraints re-shift the baseline samples at every
    evaluation."""
    if model.batch_shape:
        raise ValueError(
            "make_in_graph_nehvi_cells requires an unbatched model; got batch_shape "
            f"{model.batch_shape} (ensemble models use the evaluation-time cell path)"
        )
    post = model.posterior(X_baseline, cache=cache)
    bs = post.rsample_from_base_samples(base_prefix)  # (nmc, nb, m)
    ref_b = torch.broadcast_to(ref_point, (bs.shape[-1],))
    if baseline_mask is not None:
        bs = torch.where(baseline_mask[..., :, None], bs, ref_b - 1.0)
    return cells_from_baseline_samples(bs, ref_point, clip_max=clip_max)


def make_qnehvi(
    cls,
    model: SingleTaskGP,
    ref_point,
    q: int,
    X_baseline: Tensor,
    num_samples: int = DEFAULT_MC_SAMPLES,
    seed: int = 0,
    prune_baseline: bool = False,
    **kwargs,
):
    """Build q(Log)NEHVI with fixed qMC base samples over the baseline, the
    q candidates and any `X_pending`; without outcome constraints the
    per-sample cells are built here, once. `prune_baseline=True` raises
    until ROADMAP item 19."""
    _refuse(model, prune_baseline)
    dev = model.X.device
    ref_point = torch.as_tensor(ref_point, dtype=model.X.dtype, device=dev)
    nb = X_baseline.shape[-2]
    masks, signs = _subset_masks(q, device=dev)
    base = _draw_base_samples(nb + q + _n_pending(kwargs), 2, num_samples, seed, device=dev)
    acqf = cls(
        model=model, cache=model.train_chol(), base_samples=base, X_baseline=X_baseline,
        ref_point=ref_point, masks=masks, signs=signs, **kwargs,
    )
    if not kwargs.get("constraints"):
        lo, up = make_in_graph_nehvi_cells(
            model, acqf.cache, X_baseline, base[:, :nb, :], ref_point,
            baseline_mask=kwargs.get("baseline_mask"),
        )
        acqf = dataclasses.replace(acqf, cell_lower=lo, cell_upper=up)
    return acqf
