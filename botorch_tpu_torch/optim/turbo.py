r"""TuRBO: trust-region Bayesian optimization (config 5; counterpart of
`botorch_tpu/optim/turbo.py`), the TuRBO-1 state machine of
[Eriksson2019turbo]:

  * an axis-aligned trust region centred on the incumbent, with base edge
    `length` scaled per dimension by the model's ARD lengthscales
    (normalized to unit geometric mean);
  * candidates are perturbations of the centre inside the region, each
    dimension perturbed with probability `min(1, 20/d)` and at least one
    always;
  * the pick is Thompson sampling with pathwise (Matheron) draws, for an
    exact GP and for an SVGP;
  * `length` doubles after `success_streak` successes (capped at 1.6),
    halves after `failure_streak` failures; a length below 0.5^7 restarts.

`run_turbo` is the host-driven loop: every tensor stays on the device,
and the host reads one flag an iteration (the restart). The reference's
`run_turbo_compiled`, the same loop as one XLA program, is not ported yet
(ROADMAP item 16b).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import torch

from botorch_tpu_torch.fit import fit_gp
from botorch_tpu_torch.generation.sampling import max_posterior_sampling
from botorch_tpu_torch.models.approximate_gp import SVGP, fit_svgp, make_svgp
from botorch_tpu_torch.models.gp import SingleTaskGP, make_gp
from botorch_tpu_torch.sampling.pathwise import PathDraws
from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table
from botorch_tpu_torch.settings import make_generator, resolve_device, resolve_dtype

Tensor = torch.Tensor


@dataclass(frozen=True)
class TurboState:
    length: Tensor  # () current trust-region base edge length
    success_counter: Tensor  # () int32
    failure_counter: Tensor  # () int32
    best_value: Tensor  # ()
    restart_triggered: Tensor  # () bool
    length_min: float = 0.5**7
    length_max: float = 1.6
    success_streak: int = 3
    failure_streak: int = 5

    def replace(self, **kw) -> "TurboState":
        return dataclasses.replace(self, **kw)


def turbo_init(best_value: Union[Tensor, float] = -float("inf"), device=None,
               **kwargs) -> TurboState:
    """A fresh trust region (length 0.8). A tensor `best_value` keeps its
    dtype and device; a number becomes float32 on `device` (CUDA unless
    given)."""
    if isinstance(best_value, Tensor):
        best = best_value.detach().reshape(())
    else:
        best = torch.tensor(best_value, dtype=torch.float32, device=resolve_device(device))
    int32 = dict(dtype=torch.int32, device=best.device)
    return TurboState(
        length=torch.tensor(0.8, dtype=best.dtype, device=best.device),
        success_counter=torch.zeros((), **int32),
        failure_counter=torch.zeros((), **int32),
        best_value=best,
        restart_triggered=torch.zeros((), dtype=torch.bool, device=best.device),
        **kwargs,
    )


def turbo_update(state: TurboState, Y_next: Tensor) -> TurboState:
    """Counters and length after observing a candidate batch."""
    y_max = torch.max(Y_next).to(state.best_value.dtype)
    improved = y_max > state.best_value + 1e-3 * torch.abs(state.best_value)
    succ = torch.where(improved, state.success_counter + 1, 0).to(torch.int32)
    fail = torch.where(improved, 0, state.failure_counter + 1).to(torch.int32)
    grow = succ >= state.success_streak
    shrink = fail >= state.failure_streak
    length = torch.where(
        grow,
        torch.clamp(2.0 * state.length, max=state.length_max),
        torch.where(shrink, 0.5 * state.length, state.length),
    )
    return state.replace(
        length=length,
        success_counter=torch.where(grow, 0, succ).to(torch.int32),
        failure_counter=torch.where(shrink, 0, fail).to(torch.int32),
        best_value=torch.maximum(state.best_value, y_max),
        restart_triggered=length < state.length_min,
    )


class TurboDraws(NamedTuple):
    """The random inputs of one candidate-generation step."""

    u: Tensor  # (n_c, d) uniforms placing the perturbations (unused with Sobol)
    mask_u: Tensor  # (n_c, d) uniforms choosing the perturbed dims
    forced: Tensor  # (n_c,) int64: the dim each candidate always perturbs
    ts: Union[PathDraws, Tensor]  # the Thompson draws: PathDraws, or joint base samples


def _is_pathwise(model) -> bool:
    """Exact unbatched GPs and SVGPs have pathwise draws; any other model
    takes a joint posterior draw."""
    if isinstance(model, SVGP):
        return True
    return isinstance(model, SingleTaskGP) and not model.batch_shape


def trust_region_lengthscale(model) -> Tensor:
    """The ARD lengthscales that shape the region: an exact GP's first
    output's, an SVGP's, or the median model's of an ensemble (the average
    of the two middle values for an even count, as `jnp.median`)."""
    if isinstance(model, SVGP):
        ls = model.lengthscale
    else:
        ls = model.params.lengthscale[..., 0, :]
    if ls.ndim > 1:
        ls = torch.quantile(ls.reshape(-1, ls.shape[-1]), 0.5, dim=0, interpolation="midpoint")
    return ls


def turbo_candidate_set(
    model,
    state: TurboState,
    X_center: Tensor,
    generator: Optional[torch.Generator] = None,
    n_candidates: int = 2048,
    sobol: Optional[tuple[Tensor, Tensor]] = None,
    sobol_skip: int = 0,
    lengthscale_override: Optional[Tensor] = None,
    draws: Optional[TurboDraws] = None,
) -> Tensor:
    """The `(n_c, d)` perturbation set of one TuRBO step in the unit cube."""
    d = X_center.shape[-1]
    kw = dict(dtype=X_center.dtype, device=X_center.device)
    ls = trust_region_lengthscale(model) if lengthscale_override is None else lengthscale_override
    weights = ls / torch.exp(torch.mean(torch.log(ls)))  # unit geometric mean
    lb = torch.clamp(X_center - 0.5 * state.length * weights, 0.0, 1.0)
    ub = torch.clamp(X_center + 0.5 * state.length * weights, 0.0, 1.0)
    if draws is None:
        shape = (n_candidates, d)
        draws = TurboDraws(
            u=torch.rand(shape, generator=generator, **kw),
            mask_u=torch.rand(shape, generator=generator, **kw),
            forced=torch.randint(0, d, (n_candidates,), generator=generator, device=kw["device"]),
            ts=None,
        )
    u = draws.u if sobol is None else draw_sobol(*sobol, n_candidates, skip=sobol_skip,
                                                 dtype=X_center.dtype)
    pert = lb + (ub - lb) * u
    # perturb each dim with probability min(1, 20/d), and at least one
    mask = draws.mask_u <= min(1.0, 20.0 / d)
    mask = mask | torch.nn.functional.one_hot(draws.forced, d).to(torch.bool)
    return torch.where(mask, pert, X_center)


def generate_turbo_candidates(
    model,
    state: TurboState,
    X_center: Tensor,
    generator: Optional[torch.Generator] = None,
    n_candidates: int = 2048,
    q: int = 1,
    sobol: Optional[tuple[Tensor, Tensor]] = None,
    sobol_skip: int = 0,
    num_features: int = 512,
    lengthscale_override: Optional[Tensor] = None,
    draws: Optional[TurboDraws] = None,
) -> Tensor:
    """One TuRBO candidate-generation step in the unit cube: `(q, d)`
    candidates chosen by Thompson sampling over the perturbation set, from
    `generator` or from `draws`. An ensemble (a `SingleTaskGP` with a
    non-empty `batch_shape`) raises: its joint draw would pick per member."""
    if isinstance(model, SingleTaskGP) and model.batch_shape:
        raise NotImplementedError(
            "generate_turbo_candidates over an ensemble (a SingleTaskGP with batch_shape "
            f"{model.batch_shape}) is not supported: Thompson sampling would return one pick "
            "per ensemble member, not (q, d) candidates"
        )
    X_cand = turbo_candidate_set(model, state, X_center, generator, n_candidates, sobol,
                                 sobol_skip, lengthscale_override, draws)
    return max_posterior_sampling(
        model, X_cand, generator, num_samples=q,
        method="pathwise" if _is_pathwise(model) else "joint",
        num_features=num_features, draws=None if draws is None else draws.ts,
    )


def run_turbo(
    objective,
    d: int,
    n_init: int,
    iterations: int,
    generator: Optional[torch.Generator] = None,
    q: int = 1,
    n_candidates: int = 2048,
    capacity: Optional[int] = None,
    fit_restarts: int = 2,
    fit_maxiter: int = 50,
    seed: int = 0,
    model_type: str = "exact",
    svgp_inducing: int = 256,
    svgp_steps: int = 400,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> tuple[Tensor, Tensor]:
    """TuRBO-1 for `objective: (k, d) -> (k,)`, maximized over the unit
    cube, on `device` (CUDA unless given). The initial design is the
    scrambled Sobol sequence of `seed`; every other draw comes from
    `generator` (seeded with `seed` if None). A restart resets the trust
    region and keeps the data.

    `model_type="exact"` refits the padded, masked exact GP (`capacity`
    rows) every iteration; `"svgp"` fits a sparse variational GP with
    `svgp_inducing` inducing points over the valid prefix for
    `svgp_steps` Adam steps (minibatches of up to 512). Returns `(X, Y)`."""
    if model_type not in ("exact", "svgp"):
        raise ValueError(f"model_type must be 'exact' or 'svgp', got {model_type!r}")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if generator is None:
        generator = make_generator(seed, device)
    capacity = capacity or (n_init + iterations * q)
    sv, shift = sobol_table(d, scramble=True, seed=seed, device=device)
    X0 = draw_sobol(sv, shift, n_init, dtype=dtype)
    Xb = torch.zeros((capacity, d), dtype=dtype, device=device)
    Yb = torch.zeros((capacity,), dtype=dtype, device=device)
    Xb[:n_init] = X0
    Yb[:n_init] = objective(X0).to(dtype)
    n = n_init
    state = turbo_init(best_value=torch.max(Yb[:n]))
    rows = torch.arange(capacity, device=device)
    for _ in range(iterations):
        mask = rows < n
        if model_type == "svgp":
            model = fit_svgp(
                make_svgp(Xb[:n], Yb[:n], num_inducing=svgp_inducing, device=device),
                generator, steps=svgp_steps, batch_size=min(512, n), device=device,
            )
            ls = model.lengthscale
        else:
            model = fit_gp(make_gp(Xb, Yb[:, None], mask=mask, device=device), generator,
                           num_restarts=fit_restarts, maxiter=fit_maxiter, device=device)
            ls = None
        best_idx = torch.argmax(torch.where(mask, Yb, -torch.inf)).reshape(1)
        center = Xb.index_select(0, best_idx)[0]
        cand = generate_turbo_candidates(model, state, center, generator,
                                         n_candidates=n_candidates, q=q,
                                         lengthscale_override=ls)
        y_new = objective(cand).to(dtype)
        Xb = torch.cat([Xb[:n], cand, Xb[n + q:]])
        Yb = torch.cat([Yb[:n], y_new, Yb[n + q:]])
        n += q
        state = turbo_update(state, y_new)
        if bool(state.restart_triggered):
            state = turbo_init(best_value=torch.max(Yb[:n]))
    return Xb[:n], Yb[:n]
