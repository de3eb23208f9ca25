r"""Fully-Bayesian SAAS GP with NUTS inference (counterpart of
`botorch_tpu/models/fully_bayesian.py`).

The SAAS prior ("sparse axis-aligned subspaces", [Eriksson2021saasbo]) puts
a global HalfCauchy(0.1) shrinkage `tausq` times per-dim HalfCauchy(1) on
the inverse squared lengthscales:

  * outputscale ~ Gamma(2.0, 0.15)
  * mean        ~ Normal(0, 1)
  * noise       ~ MIN_NOISE + Gamma(0.9, 10)   (inferred-noise case)
  * tausq       ~ HalfCauchy(0.1)
  * ilsq_d      ~ HalfCauchy(1);  lengthscale_d = (tausq * ilsq_d)^(-1/2)
  * K = outputscale * Matern52(X / ls) + noise * I;  Y | K ~ MVN(mean, K)

NUTS (`sampling/nuts.py`) runs over the unconstrained
`z = [mean, log outputscale, log noise_g, log tausq, log ilsq_1..d]` with
exact log-Jacobian terms, chains batched as a leading dim. The potential
takes `z (C, k)`: its kernel matrix is K2 (`kernel_fn("matern52")`, one
launch of `(C, n, n)`) and its factor, solve and log-determinant are K1
(at `(C, n)`), once per leapfrog for all chains. The fit evaluates the
potential and its gradient in closed form from K1's `alpha` and `Kinv`
(`make_saas_potential_and_grad`), with no backward pass: a backward
through K2 would replay its plain version, ~200 more device launches a
leapfrog. A
validity mask keeps padded rows decoupled (identity rows), so K1 and K2
see one shape for a whole BO loop. Thinned draws load into an ensemble
`SingleTaskGP` whose leading params dim is the MCMC dim.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from botorch_tpu_torch.models import priors as priors_mod
from botorch_tpu_torch.models.gp import GPParams, SingleTaskGP, make_gp
from botorch_tpu_torch.ops.chol import DEFAULT_JITTER, add_jitter
from botorch_tpu_torch.ops.kernels import kernel_fn
from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet, mvn_quad_logdet_parts
from botorch_tpu_torch.sampling.nuts import TransitionDraws, run_nuts
from botorch_tpu_torch.settings import make_generator, resolve_device

Tensor = torch.Tensor

_log_2pi = math.log(2.0 * math.pi)
_log_sqrt_2pi = 0.5 * _log_2pi
MIN_NOISE = priors_mod.MIN_INFERRED_NOISE_LEVEL  # 1e-4


def _unpack(z: Tensor, d: int, infer_noise: bool):
    """`z (..., k)` -> (mean, outputscale, noise, noise_g, tausq, ilsq,
    lengthscale, log_jacobian), each over the leading dims of `z`."""
    mean = z[..., 0]
    outputscale = torch.exp(z[..., 1])
    idx = 2
    if infer_noise:
        noise_g = torch.exp(z[..., idx])
        noise = MIN_NOISE + noise_g
        idx += 1
    else:
        noise_g = noise = None
    tausq = torch.exp(z[..., idx])
    ilsq = torch.exp(z[..., idx + 1:idx + 1 + d])
    lengthscale = torch.rsqrt(tausq[..., None] * ilsq)
    # every coordinate after the mean is log-transformed: log|J| = sum(z[1:])
    log_jac = torch.sum(z[..., 1:], dim=-1)
    return mean, outputscale, noise, noise_g, tausq, ilsq, lengthscale, log_jac


def make_saas_potential(
    X: Tensor, Y_std: Tensor, Yvar_std: Optional[Tensor] = None, mask: Optional[Tensor] = None
):
    """Negative log joint density of the SAAS model, `z (C, k) -> (C,)`.

    `Y_std (n,)`: standardized targets. `mask (n,)` marks the valid rows of
    padded buffers. Returns `(potential, z_dim, infer_noise)`."""
    n, d = X.shape
    infer_noise = Yvar_std is None
    z_dim = (2 + (1 if infer_noise else 0)) + 1 + d

    hc_tau = priors_mod.HalfCauchy(0.1)
    hc_ilsq = priors_mod.HalfCauchy(1.0)
    g_os = priors_mod.Gamma(2.0, 0.15)
    g_noise = priors_mod.Gamma(0.9, 10.0)
    n_mean = priors_mod.Normal(0.0, 1.0)
    matern52 = kernel_fn("matern52")
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    if mask is not None:
        mvec = mask.to(X.dtype)
        pair = mvec[:, None] * mvec[None, :]
        n_valid = torch.sum(mvec)
    else:
        mvec = None
        n_valid = n

    def potential(z: Tensor) -> Tensor:
        (mean, outputscale, noise, noise_g, tausq, ilsq, lengthscale,
         log_jac) = _unpack(z, d, infer_noise)
        lp = n_mean.log_prob(mean) + g_os.log_prob(outputscale)
        lp = lp + hc_tau.log_prob(tausq) + torch.sum(hc_ilsq.log_prob(ilsq), dim=-1)
        if infer_noise:
            lp = lp + g_noise.log_prob(noise_g)
            noise_diag = noise
        else:
            noise_diag = torch.mean(Yvar_std).expand(mean.shape)
        K = outputscale[..., None, None] * matern52(X, X, lengthscale)
        K = K + noise_diag[..., None, None] * eye
        resid = Y_std - mean[..., None]
        if mvec is not None:
            K = K * pair + (1.0 - pair) * eye
            resid = resid * mvec
        quad, ld = mvn_quad_logdet(add_jitter(K), resid)
        loglik = -0.5 * (quad + ld + n_valid * _log_2pi)
        return -(loglik + lp + log_jac)

    return potential, z_dim, infer_noise


def make_saas_potential_and_grad(
    X: Tensor, Y_std: Tensor, Yvar_std: Optional[Tensor] = None, mask: Optional[Tensor] = None
) -> Callable[[Tensor], tuple[Tensor, Tensor]]:
    """`z (C, k) -> (U (C,), dU/dz (C, k))`: `make_saas_potential`'s
    potential and its gradient in closed form, with no backward pass.

    One K2 launch gives the kernel matrices and one K1 launch the factor,
    solve, log-determinant and `Kinv` of all chains; the likelihood's
    gradient in the jittered covariance is `(Kinv - alpha alpha^T) / 2`
    (the JAX package's `mvn_quad_logdet` VJP), carried through the jitter,
    the mask and the Matern-5/2 form to z. The lengthscale terms use the
    per-dim squared differences of the inputs, as K2 sums them. The priors
    act on `e = exp(z[1:])` column by column: Gamma on the outputscale (and
    the noise), HalfCauchy on `tausq` and the `ilsq`."""
    n, d = X.shape
    infer_noise = Yvar_std is None
    kw = dict(dtype=X.dtype, device=X.device)
    gammas = [priors_mod.Gamma(2.0, 0.15)] + ([priors_mod.Gamma(0.9, 10.0)] if infer_noise else [])
    n_gamma = len(gammas)
    conc = torch.tensor([p.concentration for p in gammas], **kw)
    rate = torch.tensor([p.rate for p in gammas], **kw)
    gamma_const = sum(p.concentration * math.log(p.rate) - math.lgamma(p.concentration)
                      for p in gammas)
    hc_scale = torch.tensor([0.1] + [1.0] * d, **kw)
    hc_const = (d + 1) * math.log(2.0 / math.pi) - math.log(0.1)
    matern52 = kernel_fn("matern52")
    eye = torch.eye(n, **kw)
    mvec = torch.ones(n, **kw) if mask is None else mask.to(X.dtype)
    pair = mvec[:, None] * mvec[None, :]
    pad_eye = (1.0 - pair) * eye
    const = 0.5 * (n if mask is None else float(torch.sum(mvec))) * _log_2pi - (gamma_const + hc_const) \
        + _log_sqrt_2pi
    fixed_noise = None if infer_noise else torch.mean(Yvar_std)
    jitter = DEFAULT_JITTER
    sqrt5 = math.sqrt(5.0)
    x_diff_sq = torch.square(X[:, None, :] - X[None, :, :])  # (n, n, d)

    def potential_and_grad(z: Tensor):
        mean = z[:, 0]
        e = torch.exp(z[:, 1:])  # outputscale, [noise_g], tausq, ilsq_1..d
        outputscale = e[:, 0]
        hc = e[:, n_gamma:]
        inv_ls_sq = hc[:, :1] * hc[:, 1:]  # tausq * ilsq = lengthscale^-2
        # -log prior - log|J| and its gradient in z[1:]
        u = torch.square(hc / hc_scale)
        neg_lp = 0.5 * torch.square(mean) + torch.sum(
            rate * e[:, :n_gamma] - (conc - 1.0) * z[:, 1:1 + n_gamma], dim=-1
        ) + torch.sum(torch.log1p(u), dim=-1) - torch.sum(z[:, 1:], dim=-1)
        g_prior = torch.cat([rate * e[:, :n_gamma] - conc, 2.0 * u / (1.0 + u) - 1.0], dim=-1)

        K_raw = matern52(X, X, torch.rsqrt(inv_ls_sq))  # (C, n, n), K2
        noise = MIN_NOISE + e[:, 1] if infer_noise else fixed_noise.expand(mean.shape)
        K = (outputscale[:, None, None] * K_raw + noise[:, None, None] * eye) * pair + pad_eye
        resid = (Y_std - mean[:, None]) * mvec
        quad, ld, alpha, kinv = mvn_quad_logdet_parts(add_jitter(K, jitter), resid)  # K1
        value = 0.5 * (quad + ld) + neg_lp + const

        # dU/dK: the likelihood's gradient in the jittered matrix, plus the
        # jitter's dependence on mean(|diag K|)
        G = 0.5 * (kinv - alpha[:, :, None] * alpha[:, None, :])
        diag_G = torch.diagonal(G, dim1=-2, dim2=-1)
        G = (G + (jitter / n) * diag_G.sum(-1)[:, None, None] * eye) * pair
        # Matern-5/2: dk/dlog(ls_d) = (5/3)(1 + s) exp(-s) (x_d - x'_d)^2 / ls_d^2, s = sqrt(5) r
        sq = x_diff_sq * inv_ls_sq[:, None, None, :]  # (C, n, n, d)
        sqrt5_r = sqrt5 * torch.sqrt(torch.sum(sq, dim=-1))
        W = G * ((1.0 + sqrt5_r) * torch.exp(-sqrt5_r))
        g_log_ls = ((5.0 / 3.0) * outputscale)[:, None] * torch.einsum("cij,cijd->cd", W, sq)
        # back to z: log ls_d = -(z_tau + z_ilsq_d) / 2
        g_lik = [outputscale * torch.sum(G * K_raw, dim=(-2, -1))]
        if infer_noise:
            g_lik.append(e[:, 1] * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1))
        g_lik.append(-0.5 * g_log_ls.sum(-1))
        g_exp = g_prior + torch.cat([torch.stack(g_lik, dim=-1), -0.5 * g_log_ls], dim=-1)
        g_mean = mean - torch.sum(alpha * mvec, dim=-1)
        return value, torch.cat([g_mean[:, None], g_exp], dim=-1)

    return potential_and_grad


def init_saas_chains(
    generator: torch.Generator, chains: int, d: int, infer_noise: bool,
    dtype=torch.float32, device=None,
) -> Tensor:
    """Chain starts near the prior medians with jitter: mean 0,
    outputscale 1, noise_g 0.01, tausq 0.1, ilsq 1 (in log space), plus
    `0.5 * N(0, 1)` per coordinate."""
    base = [0.0, 0.0] + ([math.log(0.01)] if infer_noise else []) + [math.log(0.1)] + [0.0] * d
    z = 0.5 * torch.randn((chains, len(base)), generator=generator, dtype=dtype, device=device)
    return z + torch.tensor(base, dtype=dtype, device=device)


def fit_saas_gp(
    train_X,
    train_Y,
    generator: Optional[torch.Generator] = None,
    train_Yvar=None,
    num_warmup: int = 512,
    num_samples: int = 256,
    thinning: int = 16,
    num_chains: int = 4,
    max_depth: int = 6,
    mask=None,
    z0: Optional[Tensor] = None,
    draws: Optional[Callable[[int], TransitionDraws]] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> tuple[SingleTaskGP, dict]:
    """SAASBO model fit on `device` (CUDA unless given): NUTS over the SAAS
    posterior, thinned draws loaded into an ensemble `SingleTaskGP`.

    Each chain keeps `max(num_samples // num_chains, thinning)` draws and
    every `thinning`-th of them, flattened chain-major. `generator` (seeded
    with 0 if None) draws the chain starts and the transitions; `z0
    (num_chains, k)` and `draws` (see `run_nuts`) replace them. Returns
    `(ensemble model, NUTS stats)`."""
    device = resolve_device(device)
    if generator is None:
        generator = make_generator(0, device)
    base = make_gp(train_X, train_Y, train_Yvar=train_Yvar, kernel="matern52",
                   use_outputscale=True, mask=mask, dtype=dtype, device=device)
    Y_std = base.Y[:, 0]
    Yvar_std = None if base.Yvar is None else base.Yvar[:, 0]
    potential_and_grad = make_saas_potential_and_grad(base.X, Y_std, Yvar_std, mask=base.mask)
    if z0 is None:
        z0 = init_saas_chains(generator, num_chains, base.dim, base.infer_noise,
                              dtype=base.X.dtype, device=device)
    z0 = torch.as_tensor(z0, dtype=base.X.dtype, device=device)
    per_chain = max(num_samples // num_chains, thinning)
    samples, stats = run_nuts(potential_and_grad, z0, generator, num_warmup=num_warmup,
                              num_samples=per_chain, max_depth=max_depth, draws=draws)
    samples = samples[:, ::thinning].reshape(-1, z0.shape[1])  # (S, k), chain-major
    return load_saas_samples(samples, base), stats


def load_saas_samples(z_samples: Tensor, base: SingleTaskGP) -> SingleTaskGP:
    """Load unconstrained draws `z_samples (S, k)` into an ensemble model
    whose params carry a leading `(S,)` dim before the output dim."""
    z_samples = torch.as_tensor(z_samples, dtype=base.X.dtype, device=base.X.device)
    mean, outputscale, noise, _, _, _, lengthscale, _ = _unpack(
        z_samples, base.dim, base.infer_noise
    )
    S = z_samples.shape[0]
    if base.infer_noise:
        raw_noise = torch.log(torch.clamp(noise, min=MIN_NOISE))[:, None]
    else:
        raw_noise = base.params.raw_noise.expand(S, 1)
    params = GPParams(
        mean=mean[:, None],
        raw_lengthscale=torch.log(lengthscale)[:, None, :],
        raw_outputscale=torch.log(outputscale)[:, None],
        raw_noise=raw_noise,
    )
    return base.replace(params=params, _is_fully_bayesian=True)


def median_lengthscales(model: SingleTaskGP) -> Tensor:
    """Posterior-median ARD lengthscales `(d,)` over the ensemble; an even
    ensemble averages its two middle draws, as `jnp.median` does."""
    ls = torch.sort(model.params.lengthscale[:, 0, :], dim=0).values
    S = ls.shape[0]
    return 0.5 * (ls[(S - 1) // 2] + ls[S // 2])
