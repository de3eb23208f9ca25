r"""Synthetic test problems (counterpart of
`botorch_tpu/test_functions/synthetic.py`): Branin, Hartmann and Ackley.

These are MINIMIZATION problems, as in the reference; BO loops maximize
`-f` (`negate=True`). `__call__` takes `X (..., d)` in the problem's own
box and returns `(...)`.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


class SyntheticTestFunction:
    dim: int
    _bounds: list[tuple[float, float]]
    _optimal_value: float
    _optimizers: list[tuple[float, ...]] = []

    def __init__(self, noise_std: float = 0.0, negate: bool = False):
        self.noise_std = noise_std
        self.negate = negate
        self.bounds = torch.tensor(self._bounds, dtype=torch.float32).T  # (2, d)

    @property
    def optimal_value(self) -> float:
        return -self._optimal_value if self.negate else self._optimal_value

    @property
    def optimizers(self) -> Tensor:
        return torch.tensor(self._optimizers, dtype=torch.float32)

    def evaluate_true(self, X: Tensor) -> Tensor:
        raise NotImplementedError

    def __call__(self, X: Tensor, generator: torch.Generator | None = None) -> Tensor:
        f = self.evaluate_true(X)
        if self.noise_std > 0 and generator is not None:
            f = f + self.noise_std * torch.randn(
                f.shape, generator=generator, dtype=f.dtype, device=f.device
            )
        return -f if self.negate else f


class Branin(SyntheticTestFunction):
    """Branin-Hoo (d=2); min 0.397887 at three points."""

    dim = 2
    _bounds = [(-5.0, 10.0), (0.0, 15.0)]
    _optimal_value = 0.397887
    _optimizers = [(-math.pi, 12.275), (math.pi, 2.275), (9.42478, 2.475)]

    def evaluate_true(self, X):
        x1, x2 = X[..., 0], X[..., 1]
        a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
        r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
        return a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * torch.cos(x1) + s


_HARTMANN = {
    3: (
        [[3.0, 10, 30], [0.1, 10, 35], [3.0, 10, 30], [0.1, 10, 35]],
        [[3689, 1170, 2673], [4699, 4387, 7470], [1091, 8732, 5547],
         [381, 5743, 8828]],
        -3.86278,
        [(0.114614, 0.555649, 0.852547)],
    ),
    4: (
        [[10, 3, 17, 3.5], [0.05, 10, 17, 0.1], [3, 3.5, 1.7, 10],
         [17, 8, 0.05, 10]],
        [[1312, 1696, 5569, 124], [2329, 4135, 8307, 3736],
         [2348, 1451, 3522, 2883], [4047, 8828, 8732, 5743]],
        -3.13449,
        [(0.18744, 0.194415, 0.558172, 0.264885)],
    ),
    6: (
        [[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
         [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]],
        [[1312, 1696, 5569, 124, 8283, 5886], [2329, 4135, 8307, 3736, 1004, 9991],
         [2348, 1451, 3522, 2883, 3047, 6650], [4047, 8828, 8732, 5743, 1091, 381]],
        -3.32237,
        [(0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573)],
    ),
}


class Hartmann(SyntheticTestFunction):
    """Hartmann (d in {3, 4, 6}); 6-d min -3.32237."""

    def __init__(self, dim: int = 6, **kw):
        if dim not in _HARTMANN:
            raise ValueError("Hartmann dim must be 3, 4, or 6")
        A, P, opt, optimizers = _HARTMANN[dim]
        self.dim = dim
        self._bounds = [(0.0, 1.0)] * dim
        self._optimal_value = opt
        self._optimizers = optimizers
        self.ALPHA = torch.tensor([1.0, 1.2, 3.0, 3.2])
        self.A = torch.tensor(A, dtype=torch.float32)
        self.P = torch.tensor(P, dtype=torch.float32) * 1e-4
        super().__init__(**kw)

    def evaluate_true(self, X):
        A = self.A.to(X)
        P = self.P.to(X)
        alpha = self.ALPHA.to(X)
        inner = torch.sum(A * torch.square(X[..., None, :] - P), dim=-1)  # (..., 4)
        if self.dim == 4:
            return (1.1 - torch.sum(alpha * torch.exp(-inner), dim=-1)) / 0.839
        return -torch.sum(alpha * torch.exp(-inner), dim=-1)


class Ackley(SyntheticTestFunction):
    """Ackley (any d); min 0 at the origin, box [-32.768, 32.768]^d."""

    def __init__(self, dim: int = 2, **kw):
        self.dim = dim
        self._bounds = [(-32.768, 32.768)] * dim
        self._optimal_value = 0.0
        self._optimizers = [tuple(0.0 for _ in range(dim))]
        super().__init__(**kw)

    def evaluate_true(self, X):
        a, b, c = 20.0, 0.2, 2 * math.pi
        s1 = torch.sqrt(torch.mean(torch.square(X), dim=-1))
        s2 = torch.mean(torch.cos(c * X), dim=-1)
        return -a * torch.exp(-b * s1) - torch.exp(s2) + a + math.e
