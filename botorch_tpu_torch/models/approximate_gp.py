r"""Sparse variational GP (SVGP) for large-n Bayesian optimization
(counterpart of `botorch_tpu/models/approximate_gp.py`).

Whitened SVGP [Hensman2015scalable]:
  * `q(u) = N(L_zz nu_m + mean, L_zz S L_zz^T)` through the whitened
    variable `nu ~ N(nu_m, S)`, `S = L_v L_v^T`, so the KL term is
    `0.5 (|nu_m|^2 + tr(S) - M - logdet S)`, with no solve;
  * with `A = L_zz^-1 k_zx` the predictive is
    `mean = mu + A^T nu_m`, `cov = K_xx - A^T A + A^T S A`;
  * the ELBO is minibatch-scaled by `n / |batch|`, and `fit_svgp` runs
    Adam on `-(ELBO + log prior)` with optax's update written out;
  * inducing points start at the pivots of a pivoted Cholesky (greedy
    variance reduction).

The model is a frozen dataclass of tensors, like `models/gp.SingleTaskGP`.
Its posterior is a `GaussianPosterior`, so the analytic and MC
acquisitions take it as they take an exact GP. Every kernel matrix goes
through K2 (`ops/kernel_matrix.py`); `Kzz` is factored with
`torch.linalg.cholesky_ex`, NaN where it fails, as `jnp.linalg.cholesky`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from botorch_tpu_torch.models import priors as priors_mod
from botorch_tpu_torch.ops.chol import add_jitter, cholesky_nan, solve_triangular
from botorch_tpu_torch.ops.kernels import kernel_fn
from botorch_tpu_torch.posteriors.gaussian import GaussianPosterior
from botorch_tpu_torch.settings import make_generator, resolve_device, resolve_dtype
from botorch_tpu_torch.utils.probability import ndtr

Tensor = torch.Tensor

_log_2pi = math.log(2.0 * math.pi)
# Jitter of the inducing covariance `Kzz` (relative, as `ops/chol.add_jitter`).
KZZ_JITTER = 1e-5
# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def greedy_variance_reduction(
    X: Tensor,
    lengthscale: Tensor,
    num_inducing: int,
    kernel: str = "rbf",
    quality_scores: Optional[Tensor] = None,
) -> Tensor:
    """Pivoted-Cholesky selection of inducing points: greedily take the
    row with the largest residual conditional variance, weighted by
    `quality_scores^2` when given. Taken pivots are masked to -inf before
    the argmax, whose ties go to the first index. Each pivot launches one
    `(n x 1)` kernel column; no step reads a value back to the host.
    Returns the selected rows of `X`."""
    k = kernel_fn(kernel)
    n = X.shape[0]
    m = min(num_inducing, n)
    kw = dict(dtype=X.dtype, device=X.device)
    resid = torch.ones((n,), **kw)  # stationary kernels: k(x, x) = 1
    q2 = torch.ones((n,), **kw) if quality_scores is None else torch.square(quality_scores)
    taken = torch.zeros((n,), dtype=torch.bool, device=X.device)
    L_rows = torch.zeros((m, n), **kw)
    idx = torch.empty((m,), dtype=torch.long, device=X.device)
    for i in range(m):
        j = torch.argmax(torch.where(taken, -torch.inf, resid * q2)).reshape(1)
        Kj = k(X, X.index_select(0, j), lengthscale)[:, 0]  # (n,)
        # subtract the projections onto the pivots taken so far
        proj = L_rows.T @ L_rows.index_select(1, j)[:, 0]
        lj = (Kj - proj) / torch.sqrt(torch.clamp(resid.index_select(0, j), min=1e-12))
        L_rows[i] = lj
        resid = torch.clamp(resid - lj**2, min=0.0)
        taken.index_fill_(0, j, True)
        idx[i : i + 1] = j
    return X.index_select(0, idx)


def expected_improvement_quality(model, X: Tensor, maximize: bool = True) -> Tensor:
    """Per-point EI quality scores against the best posterior mean (the
    reference's `ExpectedImprovementQualityFunction`)."""
    post = model.posterior(X)
    if post.mean.ndim != 2 or post.mean.shape[-1] != 1:
        raise ValueError(
            "expected_improvement_quality requires a single-output, "
            f"unbatched model; got posterior mean shape {tuple(post.mean.shape)}."
        )
    mean = post.mean[..., 0]
    sigma = torch.sqrt(torch.clamp(post.variance[..., 0], min=1e-12))
    best_f = torch.max(mean) if maximize else torch.min(mean)
    u = (mean - best_f) / sigma if maximize else -(mean - best_f) / sigma
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return sigma * (phi + u * ndtr(u))


def greedy_improvement_reduction(
    model,
    X: Tensor,
    lengthscale: Tensor,
    num_inducing: int,
    kernel: str = "rbf",
    maximize: bool = True,
) -> Tensor:
    """Inducing points both diverse and in promising regions of `model`
    (the reference's `GreedyImprovementReduction`)."""
    q = expected_improvement_quality(model, X, maximize=maximize)
    return greedy_variance_reduction(X, lengthscale, num_inducing, kernel=kernel, quality_scores=q)


# Reference class names for migrating users.
GreedyVarianceReduction = greedy_variance_reduction
GreedyImprovementReduction = greedy_improvement_reduction
ExpectedImprovementQualityFunction = expected_improvement_quality


def UnitQualityFunction(X: Tensor) -> Tensor:
    return torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)


def softplus(x: Tensor) -> Tensor:
    """`log(1 + exp(x))` as `jax.nn.softplus` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclass(frozen=True)
class SVGP:
    """Whitened sparse variational GP (single output)."""

    X: Tensor  # (n, d) train inputs
    Y: Tensor  # (n,) standardized train targets
    Z: Tensor  # (M, d) inducing locations (learnable)
    nu_mean: Tensor  # (M,) whitened variational mean
    raw_L: Tensor  # (M, M) raw lower-triangular variational root (softplus diagonal)
    mean_const: Tensor  # ()
    raw_lengthscale: Tensor  # (d,)
    raw_outputscale: Tensor  # ()
    raw_noise: Tensor  # ()
    Y_loc: Tensor  # ()
    Y_scale: Tensor  # ()
    kernel: str = "matern52"
    learn_inducing: bool = True

    # the tensor fields, in the JAX package's order (`convert.svgp_*_numpy`)
    FIELDS = ("X", "Y", "Z", "nu_mean", "raw_L", "mean_const", "raw_lengthscale",
              "raw_outputscale", "raw_noise", "Y_loc", "Y_scale")
    # the variational and kernel parameters `fit_svgp` trains, Z aside
    PARAMS = ("nu_mean", "raw_L", "mean_const", "raw_lengthscale", "raw_outputscale",
              "raw_noise")

    def replace(self, **kw) -> "SVGP":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SVGP":
        """The same model with every tensor field on `device`."""
        return self.replace(**{f: getattr(self, f).to(device) for f in self.FIELDS})

    # ------------------------------------------------------------------ #
    @property
    def num_outputs(self) -> int:
        return 1

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def lengthscale(self) -> Tensor:
        return torch.exp(self.raw_lengthscale)

    @property
    def outputscale(self) -> Tensor:
        return torch.exp(self.raw_outputscale)

    @property
    def noise(self) -> Tensor:
        return torch.exp(self.raw_noise)

    @property
    def L_var(self) -> Tensor:
        """Lower-triangular variational root with a positive diagonal."""
        diag = softplus(torch.diagonal(self.raw_L)) + 1e-6
        return torch.tril(self.raw_L, -1) + torch.diag(diag)

    def _k(self, a: Tensor, b: Tensor) -> Tensor:
        return self.outputscale * kernel_fn(self.kernel)(a, b, self.lengthscale)

    def chol_zz(self) -> Tensor:
        """Lower Cholesky factor of the jittered `Kzz` (NaN if it fails)."""
        return cholesky_nan(add_jitter(self._k(self.Z, self.Z), KZZ_JITTER))

    # ------------------------------------------------------------------ #
    def _predict(self, Xq: Tensor) -> tuple[Tensor, Tensor]:
        """Whitened predictive mean `(..., q)` and covariance `(..., q, q)`
        over `Xq (..., q, d)` (standardized units). It forms the full
        `Kxx` and `cov` as the reference does, though the ELBO reads only
        their diagonal."""
        Lzz = self.chol_zz()
        Kzx = self._k(self.Z, Xq)  # (..., M, q)
        A = solve_triangular(Lzz, Kzx)  # L^-1 k_zx
        At = A.transpose(-1, -2)
        mean = self.mean_const + At @ self.nu_mean
        Kxx = self._k(Xq, Xq)
        SA = self.L_var.T @ A
        cov = Kxx - At @ A + SA.transpose(-1, -2) @ SA
        return mean, cov

    def posterior(
        self, Xq: Tensor, observation_noise: bool = False, cache=None
    ) -> GaussianPosterior:
        """Joint posterior over `Xq (..., q, d)` in original outcome units
        (`cache` is accepted for the acquisitions' sake and unused)."""
        mean, cov = self._predict(Xq)
        if observation_noise:
            cov = cov + self.noise * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        post = GaussianPosterior(mean=mean[..., None], cov=cov[..., None, :, :])
        return post.affine(self.Y_loc[None], self.Y_scale[None])

    # ------------------------------------------------------------------ #
    def elbo(self, batch_idx: Optional[Tensor] = None) -> Tensor:
        """Variational ELBO, minibatch-scaled when `batch_idx` is given."""
        n = self.Y.shape[0]
        if batch_idx is None:
            Xb, Yb, scale = self.X, self.Y, 1.0
        else:
            Xb, Yb = self.X[batch_idx], self.Y[batch_idx]
            scale = n / batch_idx.shape[0]
        mean, cov = self._predict(Xb)
        var_f = torch.clamp(torch.diagonal(cov), min=1e-10)
        noise = self.noise
        # E_q[log N(y | f, noise)] per point
        exp_ll = -0.5 * (_log_2pi + torch.log(noise) + (torch.square(Yb - mean) + var_f) / noise)
        L = self.L_var
        kl = 0.5 * (
            torch.sum(torch.square(self.nu_mean))
            + torch.sum(torch.square(L))
            - self.num_inducing
            - 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        )
        return scale * torch.sum(exp_ll) - kl

    def log_prior(self) -> Tensor:
        d = self.X.shape[-1]
        lp = torch.sum(
            priors_mod.dim_scaled_lognormal_lengthscale_prior(d).log_prob(self.lengthscale)
        )
        lp = lp + priors_mod.lognormal_noise_prior().log_prob(self.noise)
        return lp + priors_mod.gamma_outputscale_prior().log_prob(self.outputscale)

    def train_chol(self):
        """None: the acquisitions' train cache; the SVGP keeps none."""
        return None

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return ()


def make_svgp(
    train_X,
    train_Y,
    num_inducing: int = 128,
    kernel: str = "matern52",
    learn_inducing: bool = True,
    inducing_points=None,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> SVGP:
    """An SVGP on `device` (CUDA unless given) in `dtype` (float32 unless
    given), with a Standardize outcome transform (population std, as
    `jnp.std`) and inducing points from `greedy_variance_reduction` at the
    prior-mode lengthscale, or `inducing_points` when given."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    train_X = torch.as_tensor(train_X, dtype=dtype, device=device)
    train_Y = torch.as_tensor(train_Y, dtype=dtype, device=device)
    if train_Y.ndim > 1:
        train_Y = train_Y[..., 0]
    n, d = train_X.shape
    loc = torch.mean(train_Y)
    scale = torch.std(train_Y, correction=0) + 1e-8
    Y_std = (train_Y - loc) / scale
    ls0 = priors_mod.dim_scaled_lognormal_lengthscale_prior(d).mode
    kw = dict(dtype=dtype, device=device)
    if inducing_points is not None:
        Z = torch.as_tensor(inducing_points, **kw)
    else:
        Z = greedy_variance_reduction(train_X, torch.full((d,), ls0, **kw), num_inducing, kernel)
    M = Z.shape[0]
    return SVGP(
        X=train_X,
        Y=Y_std,
        Z=Z,
        nu_mean=torch.zeros((M,), **kw),
        raw_L=torch.eye(M, **kw) * math.log(math.expm1(1.0)),  # softplus^-1(1)
        mean_const=torch.zeros((), **kw),
        raw_lengthscale=torch.full((d,), math.log(ls0), **kw),
        raw_outputscale=torch.zeros((), **kw),
        raw_noise=torch.full((), math.log(0.01), **kw),
        Y_loc=loc,
        Y_scale=scale,
        kernel=kernel,
        learn_inducing=learn_inducing,
    )


def fit_svgp(
    model: SVGP,
    generator: Optional[torch.Generator] = None,
    steps: int = 1000,
    batch_size: int = 256,
    lr: float = 0.05,
    batch_indices: Optional[Tensor] = None,
    device=None,
) -> SVGP:
    """Fit on `device` (CUDA unless given) by maximizing ELBO + log prior
    with Adam, optax's update written out on one flat parameter vector
    (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments).

    When `batch_size < n` every step takes a minibatch of `batch_size`
    indices drawn with replacement from `generator` (seed 0 if None), or
    row `t` of `batch_indices (steps, batch_size)` when given (the JAX
    package's draws, for the parity tests)."""
    device = resolve_device(device)
    model = model.to(device)
    n = model.Y.shape[0]
    if batch_indices is not None:
        batch_indices = torch.as_tensor(batch_indices, dtype=torch.long, device=device)
        if batch_indices.shape != (steps, batch_size):
            raise ValueError(f"batch_indices must be ({steps}, {batch_size}), "
                             f"got {tuple(batch_indices.shape)}")
        if bool((batch_indices < 0).any() | (batch_indices >= n).any()):
            raise ValueError(f"batch_indices must lie in [0, {n})")
    elif batch_size < n:
        if generator is None:
            generator = make_generator(0, device)
        batch_indices = torch.randint(0, n, (steps, batch_size), generator=generator,
                                      device=device)
    fields = SVGP.PARAMS + (("Z",) if model.learn_inducing else ())
    shapes = [getattr(model, f).shape for f in fields]
    sizes = [math.prod(s) for s in shapes]

    def unflatten(flat: Tensor) -> dict:
        return {f: part.reshape(s) for f, part, s in zip(fields, flat.split(sizes), shapes)}

    def grad(flat: Tensor, idx: Optional[Tensor]) -> Tensor:
        v = flat.detach().requires_grad_(True)
        m = model.replace(**unflatten(v))
        (g,) = torch.autograd.grad(-(m.elbo(idx) + m.log_prior()), v)
        return g

    flat = torch.cat([getattr(model, f).reshape(-1) for f in fields]).detach()
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    for t in range(1, steps + 1):
        g = grad(flat, None if batch_indices is None else batch_indices[t - 1])
        with torch.no_grad():
            mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
            nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
            mu_hat = mu / (1.0 - ADAM_B1**t)
            nu_hat = nu / (1.0 - ADAM_B2**t)
            flat = flat + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return model.replace(**unflatten(flat))
