r"""Pathwise GP sampling by Matheron's rule (counterpart of
`botorch_tpu/sampling/pathwise.py`).

A posterior sample path is

    f(x) = phi(x)^T theta + k(x, X) K^-1 (y - phi(X)^T theta - eps)

with random Fourier prior features `phi`, `theta ~ N(0, I)` and noise
draws `eps ~ N(0, noise I)`. Once drawn, a path costs one `(n_c, L) @ (L,)`
and one `(n_c, n) @ (n,)` product at `n_c` candidates, which is what
makes Thompson sampling over thousands of candidates (TuRBO) cheap. The
kernel column `k(x, X)` is K2 (`ops/kernel_matrix.py`).

Spectral weights: rbf `w = z / ls`; Matern-nu `w = z sqrt(2 nu / chi2_{2 nu}) / ls`
(the Student-t spectral measure).

Every random input of a draw is a field of `PathDraws`: `draw_path_draws`
makes them from a `torch.Generator`, and a caller may pass its own (the
parity tests pass the JAX package's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from botorch_tpu_torch.models import priors as priors_mod
from botorch_tpu_torch.models.approximate_gp import SVGP
from botorch_tpu_torch.models.gp import SingleTaskGP
from botorch_tpu_torch.ops.chol import cholesky_solve

Tensor = torch.Tensor

_MATERN_NU = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


class PathDraws(NamedTuple):
    """The random inputs of `P` paths with `L` features over `k` update
    points."""

    z: Tensor  # (L, d) standard normals of the frequencies
    b: Tensor  # (L,) phases, uniform on [0, 2 pi)
    chi2: Optional[Tensor]  # (L, 1) chi-square_{2 nu} draws of a Matern kernel; None for rbf
    theta: Tensor  # (P, L) prior weights
    # (P, k) standard normals of the data update: the observation noise at
    # the k train points (exact GP), the whitened q(u) draw at the k
    # inducing points (SVGP)
    eps: Tensor


def draw_path_draws(
    generator: torch.Generator, kernel: str, d: int, num_paths: int, num_features: int,
    k: int, dtype=torch.float32, device=None,
) -> PathDraws:
    """`PathDraws` from `generator`."""
    if generator is None:
        raise ValueError("path draws come from an explicit torch.Generator (or are injected)")
    if kernel != "rbf" and kernel not in _MATERN_NU:
        raise ValueError(f"no spectral density for kernel {kernel!r}")
    kw = dict(generator=generator, dtype=dtype, device=device)
    z = torch.randn((num_features, d), **kw)
    b = 2.0 * math.pi * torch.rand((num_features,), **kw)
    chi2 = None
    if kernel in _MATERN_NU:
        chi2 = 2.0 * priors_mod.Gamma(_MATERN_NU[kernel], 1.0).sample(
            generator, (num_features, 1), dtype=dtype, device=device)
    theta = torch.randn((num_paths, num_features), **kw)
    eps = torch.randn((num_paths, k), **kw)
    return PathDraws(z, b, chi2, theta, eps)


def _spectral_weights(kernel: str, lengthscale: Tensor, draws: PathDraws) -> tuple[Tensor, Tensor]:
    """RFF frequencies `W (L, d)` and phases `b (L,)`."""
    if kernel == "rbf":
        w = draws.z / lengthscale
    elif kernel in _MATERN_NU:
        nu = _MATERN_NU[kernel]
        w = draws.z * torch.sqrt(2.0 * nu / draws.chi2) / lengthscale
    else:
        raise ValueError(f"no spectral density for kernel {kernel!r}")
    return w, draws.b


def _features(x: Tensor, W: Tensor, b: Tensor, feature_scale: Tensor) -> Tensor:
    return feature_scale * torch.cos(x @ W.T + b)


@dataclass(frozen=True)
class MatheronPath:
    """A batch of posterior sample paths of an exact single-output GP;
    `__call__(x (..., d))` gives `(num_paths, ...)` in original outcome
    units."""

    model: SingleTaskGP
    W: Tensor  # (L, d) shared frequencies
    b: Tensor  # (L,)
    theta: Tensor  # (P, L) prior weights
    v: Tensor  # (P, n) data-update weights K^-1 (y - prior - eps)
    feature_scale: Tensor  # () sqrt(2 * outputscale / L)

    def prior(self, x: Tensor) -> Tensor:
        """Prior component in standardized units, `(..., P)`."""
        return _features(x, self.W, self.b, self.feature_scale) @ self.theta.T

    def __call__(self, x: Tensor) -> Tensor:
        m = self.model
        p = m.params.output(0)
        Kxn = m._kernel(p, torch.atleast_2d(x), m.X)  # (..., n)
        if m.mask is not None:
            Kxn = Kxn * m.mask.to(Kxn.dtype)
        f_std = p.mean + self.prior(x) + Kxn @ self.v.T  # (..., P)
        return torch.movedim(m.Y_loc[0] + m.Y_scale[0] * f_std, -1, 0)


@dataclass(frozen=True)
class SVGPMatheronPath:
    """Posterior sample paths of a sparse variational GP: the data update
    is anchored at the inducing points, with weights from a draw of the
    variational `q(u)` and no observation noise."""

    model: SVGP
    W: Tensor  # (L, d)
    b: Tensor  # (L,)
    theta: Tensor  # (P, L)
    v: Tensor  # (P, M) update weights Kzz^-1 (u - mean - prior(Z))
    feature_scale: Tensor  # ()

    def prior(self, x: Tensor) -> Tensor:
        return _features(x, self.W, self.b, self.feature_scale) @ self.theta.T

    def __call__(self, x: Tensor) -> Tensor:
        m = self.model
        Kxz = m._k(torch.atleast_2d(x), m.Z)  # (..., M)
        f_std = m.mean_const + self.prior(x) + Kxz @ self.v.T  # (..., P)
        return torch.movedim(m.Y_loc + m.Y_scale * f_std, -1, 0)


def _draw_matheron_paths_svgp(model: SVGP, draws: PathDraws) -> SVGPMatheronPath:
    """Whitened variational sample `u = mean_const + Lzz (nu_mean + L_var eps)`,
    update weights `v = Kzz^-1 (u - mean_const - prior(Z))`."""
    W, b = _spectral_weights(model.kernel, model.lengthscale, draws)
    scale = torch.sqrt(2.0 * model.outputscale / W.shape[0])
    Z = model.Z
    priorZ = _features(Z, W, b, scale) @ draws.theta.T  # (M, P)
    nu_s = model.nu_mean[:, None] + model.L_var @ draws.eps.T  # (M, P)
    Lzz = model.chol_zz()
    v = cholesky_solve(Lzz, Lzz @ nu_s - priorZ)  # (M, P)
    return SVGPMatheronPath(model=model, W=W, b=b, theta=draws.theta, v=v.T, feature_scale=scale)


def _update_points(model) -> int:
    return model.num_inducing if isinstance(model, SVGP) else model.num_train


def draw_matheron_paths(
    model,
    generator: Optional[torch.Generator] = None,
    num_paths: int = 1,
    num_features: int = 1024,
    draws: Optional[PathDraws] = None,
):
    """Draw `num_paths` posterior sample paths of an exact single-output
    `SingleTaskGP` (Matheron update over the train points) or an `SVGP`
    (variational update over the inducing points), from `generator` or
    from `draws`."""
    if isinstance(model, SingleTaskGP) and (model.num_outputs != 1 or model.batch_shape):
        raise ValueError("pathwise sampling supports unbatched single-output models")
    if not isinstance(model, (SingleTaskGP, SVGP)):
        raise NotImplementedError(
            f"pathwise sampling of {type(model).__name__} (a ModelList's per-model "
            "paths) is not ported yet: ROADMAP item 18"
        )
    if draws is None:
        draws = draw_path_draws(generator, model.kernel, model.X.shape[-1], num_paths,
                                num_features, _update_points(model), model.X.dtype,
                                model.X.device)
    if isinstance(model, SVGP):
        return _draw_matheron_paths_svgp(model, draws)
    p = model.params.output(0)
    outputscale = p.outputscale if model.use_outputscale else torch.ones_like(p.mean)
    W, b = _spectral_weights(model.kernel, p.lengthscale, draws)
    scale = torch.sqrt(2.0 * outputscale / W.shape[0])
    # Matheron data update: v = K^-1 (y - mu - prior(X) - eps)
    priorX = _features(model.X, W, b, scale) @ draws.theta.T  # (n, P)
    noise = model.Yvar[:, 0] if model.Yvar is not None else p.noise.expand(model.num_train)
    eps = draws.eps * torch.sqrt(noise)
    resid = (model.Y[:, 0] - p.mean)[:, None] - priorX - eps.T  # (n, P)
    if model.mask is not None:
        resid = resid * model.mask.to(resid.dtype)[:, None]
    L = model.train_chol()[0]
    v = cholesky_solve(L[0], resid)  # (n, P)
    return MatheronPath(model=model, W=W, b=b, theta=draws.theta, v=v.T, feature_scale=scale)


def get_matheron_path_model(model, generator: torch.Generator, num_features: int = 1024):
    """One frozen sample path as a deterministic function `x -> f(x)`."""
    path = draw_matheron_paths(model, generator, num_paths=1, num_features=num_features)

    def fn(x: Tensor) -> Tensor:
        return path(x)[0]

    return fn


def get_gp_samples(
    model, generator: torch.Generator, num_outputs: int = 1, n_samples: int = 1,
    num_rff_features: int = 512,
):
    """The reference's deprecated name (`utils/gp_sampling.py`): a callable
    evaluating `n_samples` frozen sample paths, `(..., d) -> (n_samples, ..., 1)`."""
    if num_outputs != 1:
        raise ValueError("pathwise sampling supports single-output models")
    path = draw_matheron_paths(model, generator, num_paths=n_samples,
                               num_features=num_rff_features)

    def fn(x: Tensor) -> Tensor:
        return path(x)[..., None]

    return fn
