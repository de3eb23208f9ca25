r"""Batched No-U-Turn Sampler (counterpart of `botorch_tpu/sampling/nuts.py`).

Iterative multinomial NUTS with a dense mass matrix, Stan-style warmup
windows and dual-averaging step-size adaptation, as in the JAX package.
Chains are a leading dim (`z (C, k)`) and run in lockstep, where the JAX
package maps one chain with `vmap`:

* A chain that has stopped (its tree turned or diverged) holds its state
  through `torch.where`, as a finished lane of a mapped `while_loop` does,
  so each chain's result is that of a run of the chain alone.
* The leaves of a subtree run as a Python loop of `2**depth` masked steps
  with no read of device values; the only host read is one per doubling
  ("is any chain still building?"). `nuts_transition.leapfrogs` and
  `nuts_transition.host_reads` count both.
* The U-turn checks of a leaf against its checkpoint slots are one
  batched op over `(C, slots, k)`: the leaf index is the same for every
  chain, so the active slots are a Python range.
* Every random draw of a transition is an input (`TransitionDraws`), drawn
  from a `torch.Generator` unless given. Per chain: the momentum normals,
  the `max_depth` directions, and one stream of uniforms read in order by
  the leaves of each subtree and the decision after it. A chain's stream
  position advances only while the chain is building, as the JAX package's
  one key chain per lane is split only by lanes still running.

Step size and dual averaging stay on the device; the mass-matrix refresh
steps are Python ints (`_warmup_schedule`), so the warmup takes no device
read to find them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from botorch_tpu_torch.ops.chol import cholesky_nan

Tensor = torch.Tensor

MAX_DELTA_ENERGY = 1000.0  # divergence threshold
_MIN_UNIFORM = 1e-38


# ---------------------------------------------------------------------- #
# Mass matrix helpers (dense). `chol_cov (k, k)` is chol(Sigma), Sigma the
# INVERSE mass matrix; momenta are N(0, Sigma^-1). Rows are chains.
# ---------------------------------------------------------------------- #
def _draw_momentum(eps: Tensor, chol_cov: Tensor) -> Tensor:
    """`r = L^-T eps` per chain: `eps (C, k)` standard normals."""
    return torch.linalg.solve_triangular(chol_cov.mT, eps.mT, upper=True).mT


def _kinetic(r: Tensor, chol_cov: Tensor) -> Tensor:
    w = r @ chol_cov
    return 0.5 * torch.sum(w * w, dim=-1)


def _popcount(n: int) -> int:
    return bin(n).count("1")


def num_uniforms(max_depth: int) -> int:
    """Uniforms a chain may read in one transition: one per leaf of the
    `2**max_depth - 1` leaves and one per doubling."""
    return 2**max_depth - 1 + max_depth


class TransitionDraws(NamedTuple):
    eps: Tensor  # (C, k) momentum normals
    directions: Tensor  # (C, max_depth) in {-1, +1}
    uniforms: Tensor  # (C, num_uniforms(max_depth)) in [1e-38, 1)


def draw_transition(
    generator: torch.Generator, chains: int, k: int, max_depth: int, dtype, device
) -> TransitionDraws:
    """The random inputs of one transition, from `generator`."""
    if generator is None:
        raise ValueError("NUTS draws come from an explicit torch.Generator (or are injected)")
    kw = dict(generator=generator, dtype=dtype, device=device)
    eps = torch.randn((chains, k), **kw)
    directions = torch.where(torch.rand((chains, max_depth), **kw) < 0.5, -1.0, 1.0).to(dtype)
    uniforms = torch.clamp(torch.rand((chains, num_uniforms(max_depth)), **kw), min=_MIN_UNIFORM)
    return TransitionDraws(eps, directions, uniforms)


def leapfrog(potential_and_grad, z: Tensor, r: Tensor, g: Tensor, eps: Tensor, inv_mass: Tensor):
    """One velocity-Verlet step of every chain with its own signed step
    `eps (C, 1)`; `inv_mass = L L^T` of the mass factor. Returns `(z, r,
    pe, g)` at the new point."""
    half_eps = 0.5 * eps
    r_half = r - half_eps * g
    z_new = z + eps * (r_half @ inv_mass)
    pe_new, g_new = potential_and_grad(z_new)
    return z_new, r_half - half_eps * g_new, pe_new, g_new


def nuts_transition(
    potential_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    z: Tensor,
    pe: Tensor,
    g: Tensor,
    step_size: Tensor,
    chol_cov: Tensor,
    max_depth: int = 6,
    generator: Optional[torch.Generator] = None,
    draws: Optional[TransitionDraws] = None,
):
    """One NUTS update of every chain: `z (C, k)`, its potential `pe (C,)`
    and gradient `g (C, k)`; `step_size` a scalar tensor or `(C,)`.

    `draws` replaces the draws from `generator`. Returns `(z, pe, g,
    stats)`; `stats` holds per chain the mean accept probability, the
    divergence and turning flags, the tree depth, the number of leaves
    and the uniforms read (`uniforms_used`).

    Each chain's state is kept packed, `[z | r | g]` for a trajectory
    point and `[z | g | pe]` for a proposal, so one `torch.where` moves a
    whole point: the leaf loop is a few dozen small launches besides the
    potential's."""
    C, k = z.shape
    if draws is None:
        draws = draw_transition(generator, C, k, max_depth, z.dtype, z.device)
    dtype, device = z.dtype, z.device
    step = torch.as_tensor(step_size, dtype=dtype, device=device).expand(C)
    log_u = torch.log(draws.uniforms)
    pos = torch.zeros((C, 1), dtype=torch.long, device=device)
    # v = M^-1 r = L (L^T r) for every row
    inv_mass = chol_cov @ chol_cov.mT

    def turning(r_sum, v_first, v_last):
        return (torch.sum(r_sum * v_first, dim=-1) <= 0) | (torch.sum(r_sum * v_last, dim=-1) <= 0)

    r0 = _draw_momentum(draws.eps, chol_cov)
    energy0 = pe + _kinetic(r0, chol_cov)

    false = torch.zeros((C,), dtype=torch.bool, device=device)
    zero = torch.zeros((C,), dtype=dtype, device=device)
    # the whole tree: both edges, the proposal and the bookkeeping
    left = right = torch.cat([z, r0, g], dim=-1)
    prop = torch.cat([z, g, pe[:, None]], dim=-1)
    r_sum, log_sum_w = r0, zero
    depth = torch.zeros((C,), dtype=torch.long, device=device)
    turned_tree, diverging = false, false
    sum_accept, num_leaves = zero, zero
    building = ~false

    for j in range(max_depth):
        if j > 0:
            nuts_transition.host_reads += 1
            if not bool(building.any()):
                break
        direction = draws.directions[:, j]
        go_right = (direction > 0)[:, None]
        eps = (direction * step)[:, None]
        cur = torch.where(go_right, right, left)  # the edge the subtree grows from
        # the subtree of 2**j leaves
        s_r_sum = torch.zeros_like(r0)
        s_lsw = torch.full((C,), -math.inf, dtype=dtype, device=device)
        s_prop = torch.cat([cur[:, :k], cur[:, 2 * k:], torch.full_like(pe[:, None], math.inf)], -1)
        s_accept, s_leaves = zero, zero
        s_stop, s_div = false, false
        # checkpoints [r | v | exclusive momentum sum] at slots 0..max_depth
        ckpt = torch.zeros((C, max_depth + 1, 3 * k), dtype=dtype, device=device)
        for n in range(2**j):
            act = building & ~s_stop
            act_col = act[:, None]
            z_n, r_n, pe_n, g_n = leapfrog(potential_and_grad, cur[:, :k], cur[:, k:2 * k],
                                           cur[:, 2 * k:], eps, inv_mass)
            nuts_transition.leapfrogs += 1
            # kinetic energy as 0.5 |L^T r|^2, as the reference: it overflows
            # to +inf, where sum(r * M^-1 r) can meet +inf and -inf (NaN)
            w_n = r_n @ chol_cov
            v_n = w_n @ chol_cov.mT
            delta = energy0 - (pe_n + 0.5 * torch.sum(w_n * w_n, dim=-1))
            div_n = ~torch.isfinite(delta) | (delta < -MAX_DELTA_ENERGY)
            lw = torch.where(div_n, -math.inf, delta)
            accept = torch.exp(torch.clamp(delta, max=0.0))
            lsw_new = torch.logaddexp(s_lsw, lw)
            take = act & (log_u.gather(1, pos)[:, 0] < lw - lsw_new)
            s_prop = torch.where(take[:, None], torch.cat([z_n, g_n, pe_n[:, None]], -1), s_prop)
            r_sum_new = s_r_sum + r_n
            pc = _popcount(n)
            if n % 2 == 0:
                # even leaves store a checkpoint at slot popcount(n); its
                # momentum sum excludes the leaf
                slot = min(pc, max_depth)
                ckpt[:, slot] = torch.where(act_col, torch.cat([r_n, v_n, s_r_sum], -1), ckpt[:, slot])
                stop_n = div_n
            else:
                # odd leaves check the slots [idx_max - trailing_ones(n) + 1,
                # idx_max], idx_max = popcount(n) - 1
                hi = pc - 1
                lo = hi - _popcount(n & ~(n + 1)) + 1
                ck = ckpt[:, lo:hi + 1]
                sub_sum = r_sum_new[:, None] - ck[..., 2 * k:]
                stop_n = div_n | turning(sub_sum, ck[..., k:2 * k], v_n[:, None]).any(-1)
            cur = torch.where(act_col, torch.cat([z_n, r_n, g_n], -1), cur)
            s_r_sum = torch.where(act_col, r_sum_new, s_r_sum)
            s_lsw = torch.where(act, lsw_new, s_lsw)
            s_accept = s_accept + torch.where(act, accept, 0.0)
            s_leaves = s_leaves + act
            s_stop = s_stop | (act & stop_n)
            s_div = s_div | (act & div_n)
            pos = pos + act_col
        s_turned = s_stop & ~s_div

        # biased progressive sampling between the old tree and the subtree
        lsw_new = torch.logaddexp(log_sum_w, s_lsw)
        take = building & (log_u.gather(1, pos)[:, 0] < s_lsw - log_sum_w) & ~s_turned & ~s_div
        b_col = building[:, None]
        pos = pos + b_col
        # the U-turn check of the merged tree, on its two edge momenta
        r_sum_tot = r_sum + s_r_sum
        r_l = torch.where(go_right, left[:, k:2 * k], cur[:, k:2 * k])
        r_r = torch.where(go_right, cur[:, k:2 * k], right[:, k:2 * k])
        turned_tot = turning(r_sum_tot, r_l @ inv_mass, r_r @ inv_mass)
        left = torch.where(b_col & ~go_right, cur, left)
        right = torch.where(b_col & go_right, cur, right)
        prop = torch.where(take[:, None], s_prop, prop)
        r_sum = torch.where(b_col, r_sum_tot, r_sum)
        log_sum_w = torch.where(building, lsw_new, log_sum_w)
        depth = depth + building
        turned_tree = torch.where(building, s_turned | turned_tot, turned_tree)
        diverging = torch.where(building, s_div, diverging)
        sum_accept = sum_accept + torch.where(building, s_accept, 0.0)
        num_leaves = num_leaves + torch.where(building, s_leaves, 0.0)
        building = building & ~turned_tree & ~diverging

    nuts_transition.transitions += 1
    stats = dict(
        accept_prob=sum_accept / torch.clamp(num_leaves, min=1.0),
        diverging=diverging,
        turning=turned_tree,
        depth=depth,
        num_leaves=num_leaves,
        uniforms_used=pos[:, 0],
    )
    return prop[:, :k], prop[:, 2 * k], prop[:, k:2 * k], stats


nuts_transition.transitions = 0
nuts_transition.leapfrogs = 0  # lockstep leapfrogs: one potential and gradient of all chains
nuts_transition.host_reads = 0


# ---------------------------------------------------------------------- #
# Dual averaging + windowed dense mass adaptation (Stan-style schedule)
# ---------------------------------------------------------------------- #
class DAState(NamedTuple):
    log_eps: Tensor
    log_eps_avg: Tensor
    h_avg: Tensor
    mu: Tensor
    t: Tensor


def da_init(eps0, dtype=torch.float32, device=None) -> DAState:
    le = torch.log(torch.as_tensor(eps0, dtype=dtype, device=device))
    zero = torch.zeros((), dtype=dtype, device=device)
    return DAState(log_eps=le, log_eps_avg=le, h_avg=zero, mu=math.log(10.0) + le, t=zero)


def da_update(state: DAState, accept_prob: Tensor, target: float = 0.8) -> DAState:
    t = state.t + 1.0
    gamma, t0, kappa = 0.05, 10.0, 0.75
    h = (1.0 / (t + t0)) * (target - accept_prob) + (1.0 - 1.0 / (t + t0)) * state.h_avg
    log_eps = state.mu - torch.sqrt(t) / gamma * h
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DAState(log_eps, log_eps_avg, h, state.mu, t)


def _warmup_schedule(num_warmup: int) -> list:
    """The warmup steps after which the mass matrix is re-estimated and
    dual averaging restarts: Stan's windows (init buffer 75, windows from
    25 doubling, term buffer 50), scaled down for short warmups."""
    if num_warmup < 20:
        return []
    init_buf = min(75, int(0.15 * num_warmup))
    term_buf = min(50, int(0.1 * num_warmup))
    boundaries = []
    pos = init_buf
    w = 25
    while pos + w < num_warmup - term_buf:
        pos += w
        boundaries.append(pos)
        w *= 2
    boundaries.append(num_warmup - term_buf)
    return sorted(set(boundaries))


def _refresh(da: DAState, chol: Tensor, wsum: Tensor, wsq: Tensor, wn: float, dense: bool):
    """Mass matrix from the pooled draws of the window (shrunk toward the
    identity), and dual averaging restarted at the averaged step size. A
    factor that is not finite keeps the old one, with no device read."""
    k = chol.shape[-1]
    n = max(wn, 2.0)
    mean = wsum / n
    cov = wsq / n - torch.outer(mean, mean)
    eye = torch.eye(k, dtype=chol.dtype, device=chol.device)
    cov = (n / (n + 5.0)) * cov + (1e-3 * (5.0 / (n + 5.0))) * eye
    if not dense:
        cov = torch.diag(torch.diagonal(cov))
    chol_new = cholesky_nan(cov)
    chol = torch.where(torch.isfinite(chol_new).all(), chol_new, chol)
    zero = torch.zeros_like(da.t)
    da = DAState(log_eps=da.log_eps_avg, log_eps_avg=da.log_eps_avg, h_avg=zero,
                 mu=math.log(10.0) + da.log_eps_avg, t=zero)
    return da, chol


def safe(potential_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]]):
    """A potential that is not finite becomes `+inf`, and a gradient entry
    that is not finite becomes 0."""

    @torch.no_grad()
    def pg(z: Tensor):
        v, grad = potential_and_grad(z)
        return torch.where(torch.isfinite(v), v, math.inf), torch.where(
            torch.isfinite(grad), grad, 0.0
        )

    return pg


def run_nuts(
    potential_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    z0: Tensor,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 512,
    num_samples: int = 256,
    max_depth: int = 6,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    dense_mass: bool = True,
    draws: Optional[Callable[[int], TransitionDraws]] = None,
) -> tuple[Tensor, dict]:
    """Run NUTS chains from `z0 (C, k)` on `potential_and_grad: (C, k) ->
    ((C,), (C, k))`, the potential and its gradient; it is made `safe`
    here.

    Warmup adapts one step size for all chains by dual averaging on the
    mean accept probability over the chains, and the dense mass matrix
    from the chains' pooled draws at the `_warmup_schedule` steps; then
    `num_samples` draws are kept (thinning is the caller's). `draws(i)`
    replaces the draws of transition `i` (warmup first). Returns
    `(samples (C, num_samples, k), stats)`: the mean accept probability
    and divergence rate of the kept draws, the adapted step size and mass
    factor, and the mean leaves per chain and transition."""
    C, k = z0.shape
    dtype, device = z0.dtype, z0.device
    pg = safe(potential_and_grad)
    z = z0
    pe, g = pg(z0)
    boundaries = set(_warmup_schedule(num_warmup))
    chol = torch.eye(k, dtype=dtype, device=device)
    da = da_init(init_step_size, dtype, device)
    wsum = torch.zeros((k,), dtype=dtype, device=device)
    wsq = torch.zeros((k, k), dtype=dtype, device=device)
    wn = 0.0

    def step(i, z, pe, g, eps):
        return nuts_transition(pg, z, pe, g, eps, chol, max_depth, generator,
                               None if draws is None else draws(i))

    leaves = torch.zeros((), dtype=dtype, device=device)  # over all chains and transitions
    for it in range(num_warmup):
        z, pe, g, st = step(it, z, pe, g, torch.exp(da.log_eps))
        leaves = leaves + st["num_leaves"].sum()
        da = da_update(da, torch.mean(st["accept_prob"]), target_accept)
        # pooled moments of the window's draws for the mass estimate
        wsum = wsum + torch.sum(z, dim=0)
        wsq = wsq + z.mT @ z
        wn += C
        if it in boundaries:
            da, chol = _refresh(da, chol, wsum, wsq, wn, dense_mass)
            wsum, wsq, wn = torch.zeros_like(wsum), torch.zeros_like(wsq), 0.0
    eps_final = torch.exp(da.log_eps_avg)
    samples, accepts, divs = [], [], []
    for it in range(num_samples):
        z, pe, g, st = step(num_warmup + it, z, pe, g, eps_final)
        leaves = leaves + st["num_leaves"].sum()
        samples.append(z)
        accepts.append(st["accept_prob"])
        divs.append(st["diverging"])
    stats = dict(
        accept_prob=torch.mean(torch.stack(accepts)),
        divergence_rate=torch.mean(torch.stack(divs).to(dtype)),
        step_size=eps_final,
        chol_cov=chol,
        mean_leaves=leaves / (C * max(num_warmup + num_samples, 1)),
    )
    return torch.stack(samples, dim=1), stats
