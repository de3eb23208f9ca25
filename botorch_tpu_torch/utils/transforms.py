r"""Input and outcome normalization (counterpart of
`botorch_tpu/utils/transforms.py`). Bounds may be given as a tensor, a
numpy array or nested lists; they are moved to the device and dtype of
`X`."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _bounds_like(bounds, X: Tensor) -> Tensor:
    return torch.as_tensor(bounds, dtype=X.dtype, device=X.device)


def normalize(X: Tensor, bounds) -> Tensor:
    """Min-max scale `X` (`... x d`) to `[0, 1]^d` given `bounds` (2 x d)."""
    b = _bounds_like(bounds, X)
    return (X - b[0]) / (b[1] - b[0])


def unnormalize(X: Tensor, bounds) -> Tensor:
    """Inverse of :func:`normalize`."""
    b = _bounds_like(bounds, X)
    return X * (b[1] - b[0]) + b[0]


def standardize(Y: Tensor) -> Tensor:
    """Standardize `Y` (`... x n x m`) to zero mean and unit variance per
    output along `n`, guarding the degenerate cases (n <= 1, constant)."""
    stddim = -1 if Y.ndim <= 1 else -2
    n = Y.shape[stddim]
    if n <= 1:
        return torch.zeros_like(Y)
    mean = torch.mean(Y, dim=stddim, keepdim=True)
    std = torch.std(Y, dim=stddim, correction=1, keepdim=True)
    std = torch.where(std < 1e-12, 1.0, std)
    return (Y - mean) / std


def is_ensemble(model) -> bool:
    """Whether the model's hyperparameters carry leading batch dims beyond
    the output dim (an MCMC or fantasy ensemble)."""
    return len(tuple(getattr(model, "batch_shape", ()))) > 0


def is_fully_bayesian(model) -> bool:
    """Whether the model is a NUTS-fitted ensemble (`fit_saas_gp`)."""
    if getattr(model, "num_mcmc_samples", None):
        return True
    return bool(getattr(model, "_is_fully_bayesian", False))
