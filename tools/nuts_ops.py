"""Dispatched PyTorch ops per NUTS leapfrog of the SAAS fit, counted on the
CPU at config 3's shape (8 chains, 26 padded rows of which 14 valid,
d = 8, max depth 6).

Each op that reaches the dispatcher costs host time on the card whether or
not it launches a kernel, and the NUTS leaf loop is host-bound; this counts
them for the potential with its gradient by autograd (`make_saas_potential`
+ autograd) and in closed form (`make_saas_potential_and_grad`,
what `fit_saas_gp` runs), and for the tree bookkeeping of one transition.
On the CPU the kernels' plain versions run, so the potential's counts
include K1's and K2's plain ops (printed apart).

    python tools/nuts_ops.py
"""

import collections
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from botorch_tpu_torch.models.fully_bayesian import (  # noqa: E402
    make_saas_potential,
    make_saas_potential_and_grad,
)
from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_plain  # noqa: E402
from botorch_tpu_torch.ops.mvn_linalg import qd_plain  # noqa: E402
from botorch_tpu_torch.sampling import nuts  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with Count() as c:
        fn()
    return sum(c.ops.values())


def autograd_pg(potential):
    """The potential and its gradient by autograd, made `safe`."""

    def pg(z):
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            v = potential(zg)
            (grad,) = torch.autograd.grad(v.sum(), zg)
        return v.detach(), grad

    return nuts.safe(pg)


def main():
    gen = torch.Generator().manual_seed(0)
    n, n_valid, d, chains = 26, 14, 8, 8
    X = torch.rand(n, d, generator=gen)
    Y = torch.sin(6 * X[:, 0])
    Y = (Y - Y[:n_valid].mean()) / Y[:n_valid].std()
    mask = torch.arange(n) < n_valid
    base = torch.tensor([0.0, 0.0, math.log(0.01), math.log(0.1)] + [0.0] * d)
    z = 0.5 * torch.randn(chains, base.numel(), generator=gen) + base
    by_autograd = autograd_pg(make_saas_potential(X, Y, mask=mask)[0])
    closed_pg = nuts.safe(make_saas_potential_and_grad(X, Y, mask=mask))
    ls = torch.full((chains, d), 0.5)
    K = 2.0 * torch.eye(n).expand(chains, n, n)
    out = {
        "potential_and_grad_autograd": count(lambda: by_autograd(z)),
        "potential_and_grad_closed_form": count(lambda: closed_pg(z)),
        "k2_plain": count(lambda: kernel_matrix_plain(X, X, ls, "matern52")),
        "k1_plain": count(lambda: qd_plain(K, torch.ones(chains, n))),
    }
    pe, g = closed_pg(z)
    nuts.nuts_transition.leapfrogs = 0
    total = count(lambda: nuts.nuts_transition(closed_pg, z, pe, g, torch.tensor(0.1),
                                               torch.eye(z.shape[1]), 6, gen))
    leapfrogs = nuts.nuts_transition.leapfrogs
    out["transition_per_leapfrog"] = total / leapfrogs
    out["bookkeeping_per_leapfrog"] = total / leapfrogs - out["potential_and_grad_closed_form"]
    out["leapfrogs"] = leapfrogs
    print(json.dumps(out))


if __name__ == "__main__":
    main()
