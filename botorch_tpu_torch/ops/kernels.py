r"""GP covariance-kernel matrices (counterpart of `botorch_tpu/ops/kernels.py`).

The raw kernels here are plain PyTorch: one `x @ z^T` contraction plus an
elementwise epilogue, with inputs pre-scaled by the ARD lengthscales. They
take `x: (..., n, d)`, `z: (..., m, d)`, `lengthscale: (..., d)` and
broadcast over leading batch dims (restarts, outputs). They are also the
plain version of kernel K2 (`ops/kernel_matrix.py`).

`kernel_fn(name)` is what the models call: for the four stationary kernels
it returns the K2 wrapper, which launches the CUDA kernel on a CUDA tensor
and runs the raw kernel on a CPU tensor.
"""

from __future__ import annotations

import math

import torch

from botorch_tpu_torch.utils.safe_math import maximum

Tensor = torch.Tensor

_sqrt5 = math.sqrt(5.0)
_sqrt3 = math.sqrt(3.0)


def pairwise_sqdist(x: Tensor, z: Tensor) -> Tensor:
    """Squared Euclidean distances `(..., n, m)` as
    `|x|^2 + |z|^2 - 2 x.z`, clamped at zero against cancellation. The
    matrix product runs in full float32 (TF32 is off, `settings.py`)."""
    x2 = torch.sum(torch.square(x), dim=-1)[..., :, None]
    z2 = torch.sum(torch.square(z), dim=-1)[..., None, :]
    xz = torch.matmul(x, z.transpose(-1, -2))
    return maximum(x2 + z2 - 2.0 * xz, 0.0)


def pairwise_dist(x: Tensor, z: Tensor) -> Tensor:
    """Euclidean distance with a safe sqrt (zero gradient at 0), so Matern
    gradients stay finite on the diagonal."""
    d2 = pairwise_sqdist(x, z)
    pos = d2 > 0
    safe = torch.sqrt(torch.where(pos, d2, 1.0))
    return torch.where(pos, safe, 0.0)


def _scale(x: Tensor, lengthscale: Tensor) -> Tensor:
    """`x (..., n, d) / ls (..., d)`, broadcasting leading batch dims."""
    return x / lengthscale[..., None, :]


def rbf(x: Tensor, z: Tensor, lengthscale: Tensor) -> Tensor:
    """ARD RBF (squared-exponential) kernel matrix."""
    return torch.exp(
        -0.5 * pairwise_sqdist(_scale(x, lengthscale), _scale(z, lengthscale))
    )


def matern52(x: Tensor, z: Tensor, lengthscale: Tensor) -> Tensor:
    """ARD Matern-5/2 kernel matrix."""
    r = pairwise_dist(_scale(x, lengthscale), _scale(z, lengthscale))
    sr = _sqrt5 * r
    return (1.0 + sr + (5.0 / 3.0) * torch.square(r)) * torch.exp(-sr)


def matern32(x: Tensor, z: Tensor, lengthscale: Tensor) -> Tensor:
    """ARD Matern-3/2 kernel matrix."""
    r = pairwise_dist(_scale(x, lengthscale), _scale(z, lengthscale))
    sr = _sqrt3 * r
    return (1.0 + sr) * torch.exp(-sr)


def matern12(x: Tensor, z: Tensor, lengthscale: Tensor) -> Tensor:
    """ARD Matern-1/2 (exponential) kernel matrix."""
    r = pairwise_dist(_scale(x, lengthscale), _scale(z, lengthscale))
    return torch.exp(-r)


KERNELS = {
    "rbf": rbf,
    "matern52": matern52,
    "matern32": matern32,
    "matern12": matern12,
}


def kernel_fn(name: str):
    """The kernel-matrix function for `name`, routed through kernel K2."""
    if name not in KERNELS:
        raise ValueError(f"Unknown kernel {name!r}; have {sorted(KERNELS)}")
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix

    def k(x: Tensor, z: Tensor, lengthscale: Tensor) -> Tensor:
        return kernel_matrix(x, z, lengthscale, name)

    return k
