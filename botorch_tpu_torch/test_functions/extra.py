r"""Constrained test problems (counterpart of the constrained part of
`botorch_tpu/test_functions/extra.py`): Gramacy and the Hartmann problems
with a norm constraint.

`evaluate_slack(X)` gives `(..., num_constraints)` slacks, feasible where
every slack is `>= 0`; `__call__` gives the objective as in
`test_functions/synthetic.py` (MINIMIZATION; `negate=True` to maximize).
"""

from __future__ import annotations

import math

import torch

from botorch_tpu_torch.test_functions.synthetic import Hartmann, SyntheticTestFunction

Tensor = torch.Tensor


class ConstrainedSyntheticTestFunction(SyntheticTestFunction):
    """A problem with `num_constraints` slack constraints `s_i(x) >= 0`."""

    num_constraints: int = 1

    def evaluate_slack(self, X: Tensor) -> Tensor:
        raise NotImplementedError

    def is_feasible(self, X: Tensor) -> Tensor:
        return torch.all(self.evaluate_slack(X) >= 0, dim=-1)


class ConstrainedGramacy(ConstrainedSyntheticTestFunction):
    """Gramacy et al. (2016), d = 2: minimize `x1 + x2` subject to
    `1.5 - x1 - 2 x2 - 0.5 sin(2 pi (x1^2 - 2 x2)) <= 0` and
    `x1^2 + x2^2 - 1.5 <= 0` on the unit square; min 0.5998."""

    dim = 2
    num_constraints = 2
    _bounds = [(0.0, 1.0), (0.0, 1.0)]
    _optimal_value = 0.5998
    _optimizers = [(0.1954, 0.4044)]

    def evaluate_true(self, X):
        return torch.sum(X, dim=-1)

    def evaluate_slack(self, X):
        x1, x2 = X[..., 0], X[..., 1]
        c1 = 1.5 - x1 - 2 * x2 - 0.5 * torch.sin(2 * math.pi * (torch.square(x1) - 2 * x2))
        c2 = torch.square(x1) + torch.square(x2) - 1.5
        return torch.stack([-c1, -c2], dim=-1)


class ConstrainedHartmann(Hartmann, ConstrainedSyntheticTestFunction):
    """Hartmann with `||x||_2 <= 1`."""

    num_constraints = 1

    def evaluate_slack(self, X):
        return 1.0 - torch.linalg.vector_norm(X, dim=-1, keepdim=True)


class ConstrainedHartmannSmooth(Hartmann, ConstrainedSyntheticTestFunction):
    """Hartmann with the smooth constraint `||x||_2^2 <= 1`."""

    num_constraints = 1

    def evaluate_slack(self, X):
        return 1.0 - torch.sum(torch.square(X), dim=-1, keepdim=True)
