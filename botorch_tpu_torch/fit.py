r"""MAP fitting of GP hyperparameters with parallel restarts (counterpart of
`botorch_tpu/fit.py`).

One start at the model's current parameters plus `num_restarts - 1` draws
from the priors, all optimized in lockstep by the batched L-BFGS-B solver
(`ls="interp"`); the restart with the best finite MAP objective wins. The
restarts are the leading dim of the flat parameter vector, whose order is
`ravel_pytree`'s order of the JAX `GPParams` (`convert.py`). Fixed
parameters are pinned by degenerate bounds `lo = hi = value`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from botorch_tpu_torch.convert import flatten_params, unflatten_params
from botorch_tpu_torch.models import priors as priors_mod
from botorch_tpu_torch.models.gp import GPParams, SingleTaskGP
from botorch_tpu_torch.ops.lbfgs import multi_start_lbfgsb
from botorch_tpu_torch.settings import make_generator, resolve_device

Tensor = torch.Tensor


def param_bounds(model: SingleTaskGP) -> tuple[GPParams, GPParams]:
    """Raw-space box constraints: lengthscale >= 0.025, inferred noise
    >= 1e-4; unused or fixed parameters are pinned."""
    p = model.params
    full = lambda t, v: torch.full_like(t, v)  # noqa: E731
    lo = GPParams(
        mean=full(p.mean, -math.inf),
        raw_lengthscale=full(p.raw_lengthscale, math.log(priors_mod.MIN_LENGTHSCALE)),
        raw_outputscale=(
            full(p.raw_outputscale, math.log(1e-8)) if model.use_outputscale
            else p.raw_outputscale
        ),
        raw_noise=(
            full(p.raw_noise, math.log(priors_mod.MIN_INFERRED_NOISE_LEVEL))
            if model.infer_noise else p.raw_noise
        ),
    )
    hi = GPParams(
        mean=full(p.mean, math.inf),
        raw_lengthscale=full(p.raw_lengthscale, math.log(1e4)),
        raw_outputscale=(
            full(p.raw_outputscale, math.log(1e6)) if model.use_outputscale
            else p.raw_outputscale
        ),
        raw_noise=full(p.raw_noise, math.log(1e4)) if model.infer_noise else p.raw_noise,
    )
    return lo, hi


def sample_params_from_priors(
    generator: torch.Generator, model: SingleTaskGP, n: int
) -> GPParams:
    """Draw `n` hyperparameter sets from the priors (leading dim `n`).
    Parameters without priors (the mean, fixed noise) keep their values."""
    p = model.params
    kw = dict(dtype=p.mean.dtype, device=p.mean.device)
    ls_prior = priors_mod.lengthscale_prior(model.priors, model.dim)
    ls = ls_prior.sample(generator, (n, *p.raw_lengthscale.shape), **kw)
    if model.infer_noise:
        noise = priors_mod.noise_prior(model.priors).sample(
            generator, (n, *p.raw_noise.shape), **kw
        )
        raw_noise = torch.log(noise)
    else:
        raw_noise = p.raw_noise.expand(n, *p.raw_noise.shape)
    if model.use_outputscale:
        os_ = priors_mod.gamma_outputscale_prior().sample(
            generator, (n, *p.raw_outputscale.shape), **kw
        )
        raw_os = torch.log(os_)
    else:
        raw_os = p.raw_outputscale.expand(n, *p.raw_outputscale.shape)
    return GPParams(
        mean=p.mean.expand(n, *p.mean.shape),
        raw_lengthscale=torch.log(torch.clamp(ls, priors_mod.MIN_LENGTHSCALE, 1e4)),
        raw_outputscale=raw_os,
        raw_noise=raw_noise,
    )


def _prepare_fit(model: SingleTaskGP, generator: torch.Generator, num_restarts: int):
    """Batched MAP objective `(r, k) -> (r,)`, the unflatten map, restart
    starts (incumbent + prior samples) and raw-space bounds."""
    like = model.params

    def obj(V: Tensor) -> Tensor:
        return model.map_objective(unflatten_params(V, like))

    starts = [flatten_params(like)[None]]
    if num_restarts > 1:
        sampled = sample_params_from_priors(generator, model, num_restarts - 1)
        starts.append(flatten_params(sampled, batch_dims=1))
    x0 = torch.cat(starts, dim=0)
    lo_t, hi_t = param_bounds(model)
    return obj, (lambda v: unflatten_params(v, like)), x0, flatten_params(lo_t), flatten_params(hi_t)


def fit_gp(
    model: SingleTaskGP,
    generator: Optional[torch.Generator] = None,
    num_restarts: int = 8,
    maxiter: int = 100,
    x0: Optional[Tensor] = None,
    device=None,
) -> SingleTaskGP:
    """MAP-fit the hyperparameters on `device` (CUDA unless given); returns
    the fitted model.

    Restart 0 starts from the model's current parameters, the others from
    prior draws made with `generator` (seed 0 if None). `x0 (r, k)` replaces
    the starts, e.g. with ones drawn elsewhere. The restart with the best
    final MAP objective wins; non-finite results are excluded.
    """
    device = resolve_device(device)
    model = _to_device(model, device)
    if generator is None:
        generator = make_generator(0, device)
    obj, unflatten, starts, lo, hi = _prepare_fit(model, generator, num_restarts)
    if x0 is not None:
        starts = torch.as_tensor(x0, dtype=starts.dtype, device=device)
    res = multi_start_lbfgsb(obj, starts, bounds=(lo, hi), maxiter=maxiter, ls="interp")
    fun = torch.where(torch.isfinite(res.fun), res.fun, torch.inf)
    best = int(torch.argmin(fun))
    return model.replace(params=unflatten(res.x[best]))


def _to_device(model: SingleTaskGP, device: torch.device) -> SingleTaskGP:
    if model.X.device == device:
        return model
    move = lambda t: None if t is None else t.to(device)  # noqa: E731
    return model.replace(
        X=move(model.X), Y=move(model.Y), params=model.params.map(move),
        Y_loc=move(model.Y_loc), Y_scale=move(model.Y_scale),
        Yvar=move(model.Yvar), mask=move(model.mask),
    )
