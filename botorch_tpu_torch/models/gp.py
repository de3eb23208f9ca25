r"""Exact Gaussian-process regression (counterpart of
`botorch_tpu/models/gp.py`): `GPParams`, `SingleTaskGP`, `make_gp`.

The model is a frozen dataclass of tensors holding the train data, the
standardization constants and log-space hyperparameters. Hyperparameters
carry a leading `(m,)` output dim and may carry more leading batch dims
(the fit's restarts, or the `(S,)` ensemble of a NUTS fit, `batch_shape`):
every method broadcasts over them, where the JAX package used `vmap`.
Padded train data is decoupled by a validity mask (`_mask_K`), so one
capacity serves a growing BO history.

Defaults match the reference: ARD RBF kernel without outputscale, the
dim-scaled LogNormal lengthscale prior, LogNormal(-4, 1) noise prior,
constant mean, and a Standardize outcome transform baked into the model.
Composite kernels, kernel weights and `condition_on_observations` are not
part of this port yet.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from botorch_tpu_torch.models import priors as priors_mod
from botorch_tpu_torch.ops.chol import (
    DEFAULT_JITTER,
    add_jitter,
    psd_safe_cholesky,
    solve_triangular,
)
from botorch_tpu_torch.ops.kernels import kernel_fn
from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet, tril_inverse
from botorch_tpu_torch.posteriors.gaussian import GaussianPosterior
from botorch_tpu_torch.settings import resolve_device, resolve_dtype

Tensor = torch.Tensor

_log_2pi = math.log(2.0 * math.pi)

# Largest n for which `train_chol` materializes the explicit L^-1.
_EXPLICIT_LINV_MAX_N = 16384


@dataclass(frozen=True)
class GPParams:
    """Log-space GP hyperparameters; leading dims are batch dims. The field
    order is `ravel_pytree`'s order of the JAX `GPParams`."""

    mean: Tensor  # (..., m) constant mean (standardized units)
    raw_lengthscale: Tensor  # (..., m, d) log lengthscale
    raw_outputscale: Tensor  # (..., m) log outputscale (used iff use_outputscale)
    raw_noise: Tensor  # (..., m) log noise variance (used iff noise inferred)

    FIELDS = ("mean", "raw_lengthscale", "raw_outputscale", "raw_noise")

    @property
    def lengthscale(self) -> Tensor:
        return torch.exp(self.raw_lengthscale)

    @property
    def outputscale(self) -> Tensor:
        return torch.exp(self.raw_outputscale)

    @property
    def noise(self) -> Tensor:
        return torch.exp(self.raw_noise)

    def replace(self, **kw) -> "GPParams":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "GPParams":
        return GPParams(*(fn(getattr(self, f)) for f in self.FIELDS))

    def output(self, out: int) -> "GPParams":
        """The hyperparameters of output `out` (the output dim removed)."""
        return GPParams(
            mean=self.mean[..., out],
            raw_lengthscale=self.raw_lengthscale[..., out, :],
            raw_outputscale=self.raw_outputscale[..., out],
            raw_noise=self.raw_noise[..., out],
        )


@dataclass(frozen=True)
class SingleTaskGP:
    """Exact GP with Gaussian likelihood (inferred or fixed noise)."""

    X: Tensor  # (n, d) train inputs
    Y: Tensor  # (n, m) standardized train targets
    params: GPParams
    Y_loc: Tensor  # (m,)
    Y_scale: Tensor  # (m,)
    Yvar: Optional[Tensor] = None  # (n, m) fixed noise (standardized units)
    mask: Optional[Tensor] = None  # (n,) bool validity mask for padded data
    kernel: str = "rbf"
    use_outputscale: bool = False
    priors: str = "lognormal"
    # marks NUTS-fitted ensembles (`models/fully_bayesian.load_saas_samples`)
    _is_fully_bayesian: bool = False

    # ------------------------------------------------------------------ #
    def replace(self, **kw) -> "SingleTaskGP":
        return dataclasses.replace(self, **kw)

    @property
    def num_outputs(self) -> int:
        return self.Y.shape[-1]

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def num_train(self) -> int:
        return self.X.shape[-2]

    @property
    def infer_noise(self) -> bool:
        return self.Yvar is None

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """Leading batch dims of the hyperparameters before the output dim
        (the MCMC ensemble of a fully-Bayesian model)."""
        return tuple(self.params.mean.shape[:-1])

    @property
    def num_valid(self) -> Tensor:
        """Number of real (unmasked) observations."""
        if self.mask is None:
            return torch.tensor(float(self.num_train), dtype=self.X.dtype, device=self.X.device)
        return torch.sum(self.mask.to(self.X.dtype))

    def _mask_K(self, K: Tensor) -> Tensor:
        """Padded rows and columns become the identity, so their Cholesky,
        logdet and solve contributions vanish exactly."""
        if self.mask is None:
            return K
        m = self.mask.to(K.dtype)
        pair = m[..., :, None] * m[..., None, :]
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        return K * pair + (1.0 - pair) * eye

    def _mask_vec(self, v: Tensor) -> Tensor:
        if self.mask is None:
            return v
        return v * self.mask.to(v.dtype)

    # ------------------------------------------------------------------ #
    def _noise_diag(self, p: GPParams, out: int) -> Tensor:
        """Per-output noise diagonal `(..., n)` in standardized units."""
        if self.Yvar is not None:
            return self.Yvar[..., out]
        return p.noise[..., None].expand(*p.noise.shape, self.num_train)

    def _kernel(self, p: GPParams, x: Tensor, z: Tensor) -> Tensor:
        k = kernel_fn(self.kernel)(x, z, p.lengthscale)
        if self.use_outputscale:
            k = p.outputscale[..., None, None] * k
        return k

    def _train_cov(self, p: GPParams, out: int) -> Tensor:
        K = self._kernel(p, self.X, self.X)
        nd = self._noise_diag(p, out)
        return self._mask_K(K + torch.diag_embed(nd))

    # ------------------------------------------------------------------ #
    def train_chol(self, params: Optional[GPParams] = None) -> tuple:
        """Per-output Cholesky of `K + noise I`, weights `K^-1 (y - mu)` and
        the explicit inverse factor: `(L (..., m, n, n), alpha (..., m, n),
        Linv (..., m, n, n))`, or `(L, alpha)` above `_EXPLICIT_LINV_MAX_N`.

        One jitter rung serves every batch element of an output (the whole
        `(S, n, n)` stack of an ensemble), as the JAX package's
        `psd_safe_cholesky` tests all of its input for finiteness."""
        params = self.params if params is None else params
        explicit_inv = self.num_train <= _EXPLICIT_LINV_MAX_N
        Ls, alphas, Linvs = [], [], []
        for out in range(self.num_outputs):
            p = params.output(out)
            L = psd_safe_cholesky(self._train_cov(p, out), batch_dims=0)
            resid = self._mask_vec(self.Y[..., out] - p.mean[..., None])
            if explicit_inv:
                Linv = tril_inverse(L)
                w = torch.matmul(Linv, resid[..., None])
                alpha = torch.matmul(Linv.transpose(-1, -2), w)[..., 0]
            else:
                w = solve_triangular(L, resid[..., None])
                alpha = solve_triangular(L, w, trans=True)[..., 0]
                Linv = None
            Ls.append(L)
            alphas.append(alpha)
            Linvs.append(Linv)
        L = torch.stack(Ls, dim=-3)
        alpha = torch.stack(alphas, dim=-2)
        if not explicit_inv:
            return L, alpha
        return L, alpha, torch.stack(Linvs, dim=-3)

    # ------------------------------------------------------------------ #
    def mll(self, params: Optional[GPParams] = None) -> Tensor:
        """Exact marginal log likelihood, summed over outputs:
        `-(1/2) [(y-mu)^T K^-1 (y-mu) + logdet K + n log 2pi]` per output."""
        params = self.params if params is None else params
        n = self.num_valid
        total = 0.0
        for out in range(self.num_outputs):
            p = params.output(out)
            K = self._train_cov(p, out)
            resid = self._mask_vec(self.Y[..., out] - p.mean[..., None])
            quad, ld = mvn_quad_logdet(add_jitter(K, DEFAULT_JITTER), resid)
            total = total + (-0.5 * (quad + ld + n * _log_2pi))
        return total

    def log_prior(self, params: Optional[GPParams] = None) -> Tensor:
        """Log prior density over hyperparameters (no Jacobian)."""
        params = self.params if params is None else params
        ls_prior = priors_mod.lengthscale_prior(self.priors, self.dim)
        lp = torch.sum(ls_prior.log_prob(params.lengthscale), dim=(-1, -2))
        if self.infer_noise:
            lp = lp + torch.sum(
                priors_mod.noise_prior(self.priors).log_prob(params.noise), dim=-1
            )
        if self.use_outputscale:
            lp = lp + torch.sum(
                priors_mod.gamma_outputscale_prior().log_prob(params.outputscale), dim=-1
            )
        return lp

    def map_objective(self, params: GPParams) -> Tensor:
        """Negative (MLL + log prior): the MAP fitting loss."""
        return -(self.mll(params) + self.log_prior(params))

    # ------------------------------------------------------------------ #
    def posterior(
        self,
        Xq: Tensor,
        observation_noise: bool = False,
        cache: Optional[tuple] = None,
    ) -> GaussianPosterior:
        """Joint posterior over `Xq: (..., q, d)` in original outcome units."""
        cache = self.train_chol() if cache is None else cache
        if len(cache) == 3:
            L, alpha, Linv = cache
        else:
            (L, alpha), Linv = cache, None
        means, covs = [], []
        for out in range(self.num_outputs):
            p = self.params.output(out)
            Ks = self._kernel(p, self.X, Xq)  # (..., n, q)
            if self.mask is not None:
                Ks = Ks * self.mask.to(Ks.dtype)[..., :, None]
            Kss = self._kernel(p, Xq, Xq)  # (..., q, q)
            mean = p.mean[..., None, None] + torch.matmul(
                Ks.transpose(-1, -2), alpha[..., out, :, None]
            )
            if Linv is not None:
                v = torch.matmul(Linv[..., out, :, :], Ks)
            else:
                v = solve_triangular(L[..., out, :, :], Ks)
            cov = Kss - torch.matmul(v.transpose(-1, -2), v)
            if observation_noise:
                if self.Yvar is not None:
                    nz = torch.mean(self.Yvar[..., out], dim=-1)
                else:
                    nz = p.noise
                eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
                cov = cov + nz[..., None, None] * eye
            means.append(mean[..., 0])
            covs.append(cov)
        post = GaussianPosterior(
            mean=torch.stack(means, dim=-1), cov=torch.stack(covs, dim=-3)
        )
        return post.affine(self.Y_loc, self.Y_scale)


# ---------------------------------------------------------------------- #
def default_init_params(
    d: int,
    m: int = 1,
    use_outputscale: bool = False,
    priors: str = "lognormal",
    dtype=torch.float32,
    device=None,
) -> GPParams:
    """Initial hyperparameters at the prior modes."""
    ls_prior = priors_mod.lengthscale_prior(priors, d)
    noise_prior = priors_mod.noise_prior(priors)
    os0 = (
        math.log(priors_mod.gamma_outputscale_prior().mode)
        if (use_outputscale and priors == "gamma")
        else 0.0
    )
    kw = dict(dtype=dtype, device=device)
    return GPParams(
        mean=torch.zeros((m,), **kw),
        raw_lengthscale=torch.full((m, d), math.log(ls_prior.mode), **kw),
        raw_outputscale=torch.full((m,), os0, **kw),
        raw_noise=torch.full((m,), math.log(noise_prior.mode), **kw),
    )


def make_gp(
    train_X,
    train_Y,
    train_Yvar=None,
    kernel: str = "rbf",
    use_outputscale: bool = False,
    standardize: bool = True,
    params: Optional[GPParams] = None,
    mask=None,
    priors: str = "lognormal",
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> SingleTaskGP:
    """Construct a `SingleTaskGP` with a baked-in Standardize outcome
    transform, on `device` (CUDA unless given) in `dtype` (float32 unless
    given)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    train_X = as_t(train_X)
    train_Y = as_t(train_Y)
    if train_Yvar is not None:
        train_Yvar = as_t(train_Yvar)
    if params is not None:
        params = params.map(as_t)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).to(torch.bool)
    if train_Y.ndim == 1:
        train_Y = train_Y[:, None]
    n, m = train_Y.shape
    d = train_X.shape[-1]
    if standardize and (mask is not None or n > 1):
        if mask is None:
            loc = torch.mean(train_Y, dim=0)
            scale = torch.std(train_Y, dim=0, correction=1)
        else:
            w = mask.to(dtype)[:, None]
            nv = torch.clamp(torch.sum(w), min=2.0)
            loc = torch.sum(train_Y * w, dim=0) / nv
            var = torch.sum(torch.square(train_Y - loc) * w, dim=0) / (nv - 1.0)
            scale = torch.sqrt(var)
        scale = torch.where(scale < 1e-8, 1.0, scale)
    else:
        loc = torch.zeros((m,), dtype=dtype, device=device)
        scale = torch.ones((m,), dtype=dtype, device=device)
    Y_std = (train_Y - loc) / scale
    if train_Yvar is not None and train_Yvar.ndim == 1:
        train_Yvar = train_Yvar[:, None]
    Yvar_std = None if train_Yvar is None else train_Yvar / torch.square(scale)
    if params is None:
        params = default_init_params(
            d, m, use_outputscale, priors=priors, dtype=dtype, device=device
        )
    return SingleTaskGP(
        X=train_X,
        Y=Y_std,
        params=params,
        Y_loc=loc,
        Y_scale=scale,
        Yvar=Yvar_std,
        mask=mask,
        kernel=kernel,
        use_outputscale=use_outputscale,
        priors=priors,
    )
