"""On-card smoke test of botorch_tpu_torch: build, kernel checks, the
config-1 (LogEI), config-2 (qLogNEI), config-3 (SAASBO), config-4
(qLogNEHVI, m = 2) and config-5 (TuRBO, exact GP and SVGP) loops, and
constrained acquisition optimization with its two loops.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build: compile both CUDA kernels from `botorch_tpu_torch/csrc/` (one
     nvcc process per source, all at once);
  2. k1: kernel K1 (`mvn_quad_logdet`) against its plain PyTorch version
     (quad, logdet, alpha, Kinv and the closed-form gradients), in float32
     and float64, with times beside the library yardstick and the card's
     launch floor; Kinv must be exactly symmetric, and the differentiable op
     must launch K1 alone (no GEMM for Kinv);
  3. k2: kernel K2 (`kernel_matrix`) against its plain version (values:
     the plain version in float64 on the same inputs) for the four
     kernels at both loops' launch shapes and larger ones, values and
     gradients each within a stated tolerance, with times and the floor;
     at the config-2 shapes (rbf) also both of K2's paths timed on the same
     inputs (`narrow_ms`, `tiled_ms`; `path` is the one `k2_plan` picks),
     and the same at config 4's shapes (rbf, d=2, 90 padded rows and
     joint posteriors of 91-94 points), and at every shape config 5's
     benches and loops launch (float32, both paths timed), and at every
     shape the constrained loops launch (rbf, float32 and float64, both
     paths timed); and the device launches of the op's forward and
     backward;
  4. bo_step: one config-1 BO step on the card against the same step on
     the CPU (plain versions), with the same restart starts and initial
     conditions;
  5. bo_loop: the config-1 BO loop (SingleTaskGP + LogEI on Branin, d=2,
     n_init=10, 25 iterations, num_restarts=6, raw_samples=64,
     fit_restarts=2, fit_maxiter=15, acq_maxiter=15, seed 0) through
     `run_bo_loop`, with each kernel's launch count over the run, and one
     step at the last history size: wall and device time, idle share, the
     kernels' launches and K2's launches by shape and path;
  6. mc_step: one config-2 qLogNEI step on the card against the same step
     on the CPU, from the same fit starts, initial conditions and base
     samples, with the jitter rung of the joint posterior on each side;
  7. qnei_loop: config 2 (qLogNEI on Hartmann-6, q=4, n_init=16, 15
     iterations, 128 qMC samples, config 1's budgets, seed 0) through
     `run_bo_loop`, with the kernels' launches over the run (K2's by shape
     and path), the final regret beside the initial design's, and one
     profiled step at the last history size;
  8. nuts_step: one NUTS transition of 8 chains at config 3's first
     iteration (10 Branin-embedded points in 26 rows, d=8), on the card
     and on the CPU from the same chain starts and draws;
  9. nuts: `fit_saas_gp` at `bench.py:76-99`'s throughput shape (n=24,
     d=10, 64 chains, 128 warmup draws, 128 samples, thinning 8): NUTS
     transitions/s, leapfrogs and host reads per transition, accept
     probability, divergence rate, step size and K1 launches;
 10. saasbo_loop: config 3 (SAASBO on Branin embedded in d=8, n_init=10,
     16 iterations, 8 chains, 256/128/8, depth 6, ensemble LogEI with 32
     restarts, 512 raw samples, 50 iterations, seed 0) through
     `run_saasbo`, its first 5 iterations (buffers of 15 rows) at the
     config's budgets, with K1's and K2's launches by shape, the final
     regret beside the initial design's, and the active dims' median
     lengthscales beside the distractors' (its profiled step, 90-150 s
     more, runs in `tools/chip_phases.py saasbo_loop_profiled`);
 11. mo_step: one config-4 qLogNEHVI step (10 BraninCurrin points in 90
     rows, q=4 sequential greedy) on the card against the same step on the
     CPU, from the same fit starts, initial conditions of each pick and
     base samples: each pick's max |candidate difference| and the value's
     relative difference, and where a pick differs, the CPU acquisition of
     that pick at the card's candidate against its value at the CPU's;
 12. mo_loop: config 4 (qLogNEHVI on BraninCurrin, d=2, m=2, n_init=10,
     all 20 iterations, q=4 sequential greedy, num_restarts=4,
     raw_samples=32, fit_restarts=2, fit_maxiter=15, acq_maxiter=15, 32 MC
     samples, seed 0) through `run_mo_bo_loop`: iterations/s and
     evaluations/s, the observed hypervolume and its fraction of `max_hv`
     beside the initial design's, K1's and K2's launches (K2's by shape and
     path; K1 launches none, the 90 padded rows being above its n <= 64),
     and one profiled step at the last history size;
 13. turbo_step: one config-5 `generate_turbo_candidates` on the card
     against the same step on the CPU from the same draws, for
     `bench.py`'s exact GP (n=2048, d=20, 4096 candidates, q=64) and an
     SVGP of its 16384 points (256 inducing points, 2048 candidates): the
     perturbation set, the paths' values and the picks;
 14. turbo_exact: `bench.py:272-292`'s Thompson-sampling throughput
     (candidates/s over 10 calls), then `run_turbo(model_type="exact")` on
     negated Ackley-4 (n_init=10, 15 iterations, q=2, 256 candidates,
     fit_maxiter=25, seed 0): the best value beside the initial design's,
     K1's launches by shape (the fit's (2, 40)) and K2's by shape and path;
 15. turbo_svgp: `bench.py:294-331`'s ELBO steps/s (`make_svgp`, 256
     inducing points, 300 Adam steps at batch 512 on 16384 points) and
     candidates/s (2048 candidates, q=64, 10 calls), then
     `run_turbo(model_type="svgp")` on -sum((x - 0.4)^2), d=20, 16384
     Sobol points, 4 iterations of q=64, 2048 candidates, 300 steps: the
     best value beside the initial design's, K2's launches by shape and
     path, the launches of one Adam step, and one profiled iteration;
 16. constrained_step: one `optimize_acqf` of each constrained branch on
     the card against the CPU, from the same fit starts and initial
     conditions (example 06's outcome-constrained qLogEI under a linear
     inequality, example 12's LogEI on the simplex with x0 <= 0.5, an
     inter-point budget at q = 2, an intra-point nonlinear 1 - |x|^2 >= 0):
     the candidates' distance, the values, both sides' violation (the
     card's at most `FEASIBILITY_TOL`); then one whole call of each on the
     card with its own initial conditions (wall ms, device launches, host
     syncs) and the hit-and-run chain of 64 polytope points alone;
 17. constrained_loop: the ConstrainedGramacy loop (3-output GP, LogCEI,
     10 Sobol points, 20 iterations) and Hartmann-6 under sum(x) <= 3 (10
     polytope points, 12 iterations of LogEI under the linear constraint),
     config 1's budgets, seed 0: the best feasible value beside the
     design's and the optimum, every Hartmann point feasible, the regret,
     K1's and K2's launches by shape.
The k1 phase also holds K1 at config 3's NUTS shapes with one matrix of
the batch not positive definite (NaN for it, the others right, no raise).
Every phase's line carries its wall seconds (`phase_s`). The k1 and k2
phases also carry the card's SM clock and power, sampled
by `nvidia-smi` while they run, and `floor_ms`: the device time of `add_`
on a one-element tensor, the shortest kernel the card runs. Then the
per-kernel summary line, the card's name and power limit, and the final
status line. Any failed phase makes the script exit non-zero;
without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

BRANIN_OPT = 0.397887
REGRET_BAR = 0.5
LOOP_CFG = dict(
    num_restarts=6, raw_samples=64, fit_restarts=2, fit_maxiter=15, acq_maxiter=15
)
# config 2 (`bench.py:104-125`): qLogNEI on Hartmann-6, q = 4, 16 initial
# points and 15 iterations, so the padded capacity is 16 + 15 * 4 = 76
HARTMANN6_OPT = 3.32237
CONFIG2 = dict(d=6, n_init=16, iterations=15, q=4)
QNEI_CFG = dict(LOOP_CFG, acqf_name="qLogNEI", mc_samples=128)
# card against CPU in one qLogNEI step: max |candidate difference| and
# |value difference| / max(1, |value|)
MC_STEP_TOL = 2e-2
# config 3 (`bench.py:127-172`): SAASBO on Branin embedded in d = 8 (dims
# 0 and 1 active), 10 initial points and 16 iterations (capacity 26); NUTS
# with 8 chains, 256 warmup draws, 128 samples, thinning 8 (16 kept
# models), depth 6; ensemble LogEI, 32 restarts, 512 raw samples, 50
# ascent iterations
CONFIG3 = dict(d=8, n_init=10, iterations=16)
# the saasbo_loop phase runs the first 5 of those iterations (capacity 15):
# on one H100 an iteration takes ~32 s, and all 16 took 565 s of a 1273 s
# run on a slow host, above the 1200 s limit with the constrained phases;
# the nuts_step phase launches the config's 26-row shapes
SAASBO_LOOP_ITERATIONS = 5
SAASBO_LOOP_CAPACITY = CONFIG3["n_init"] + SAASBO_LOOP_ITERATIONS
SAASBO_CFG = dict(num_warmup=256, num_samples=128, thinning=8, num_chains=8, max_depth=6,
                  num_restarts=32, raw_samples=512, acq_maxiter=50)
# config 4 (`bench.py:174-218`): qLogNEHVI on BraninCurrin (d = 2, m = 2,
# reference point (-18, -6)), 10 initial points and 20 iterations of q = 4
# sequential-greedy picks, so the padded capacity is 10 + 20 * 4 = 90
CONFIG4 = dict(d=2, m=2, n_init=10, iterations=20, q=4)
MO_CFG = dict(num_restarts=4, raw_samples=32, fit_restarts=2, fit_maxiter=15, acq_maxiter=15,
              mc_samples=32)
# the loop's observed hypervolume as a fraction of BraninCurrin's max_hv:
# at least this (the JAX package measured 0.959-0.967 over its seeds, the
# BoTorch CPU replica 0.845-0.901, `BASELINE.md:71`) and above the
# initial design's
HV_FRACTION_BAR = 0.90
# card against CPU in one config-4 step: max |candidate difference| of each
# pick and |value difference| / max(1, |value|), as config 2's `MC_STEP_TOL`;
# a pick that moves must keep the CPU acquisition within this of its value
# at the CPU's own pick (relative, as the SAASBO step test holds it)
MO_STEP_TOL = 2e-2
MO_PICK_ACQ_TOL = 1e-3
# config 5 (`bench.py:272-331`): TuRBO in d = 20. Thompson-sampling
# throughput on an unfitted exact GP of 2048 points (4096 candidates, q =
# 64, 512 features); an SVGP of 16384 points with 256 inducing points, 300
# Adam steps at batch 512, 2048 candidates; 10 generation calls each
CONFIG5 = dict(d=20, exact_n=2048, svgp_n=16384, inducing=256, svgp_steps=300, batch=512,
               q=64, exact_candidates=4096, svgp_candidates=2048, gen_calls=10)
# the closed loops: exact on negated Ackley-4 at the reference test's
# budget (capacity 40, so the MAP fit launches K1 at (2, 40)); SVGP on
# -sum((x - 0.4)^2) from 16384 Sobol points, 4 iterations of q = 64
TURBO_EXACT_CFG = dict(d=4, n_init=10, iterations=15, q=2, n_candidates=256, fit_maxiter=25)
TURBO_SVGP_CFG = dict(d=CONFIG5["d"], n_init=CONFIG5["svgp_n"], iterations=4, q=CONFIG5["q"],
                      n_candidates=CONFIG5["svgp_candidates"], model_type="svgp",
                      svgp_inducing=CONFIG5["inducing"], svgp_steps=CONFIG5["svgp_steps"])
# card against CPU in one TuRBO step from the same draws: max |path value
# difference| / max(1, max |value|). On the CPU float32 lies 5.7e-5 (exact
# GP, a solve against a 2048-point covariance of condition ~1e4) and 9e-6
# (SVGP) from float64 at these inputs; a draw whose top two values are
# further apart than twice this must pick the same candidate
TURBO_STEP_TOL = 5e-4
# `bench.py:76-99`'s NUTS throughput shape
NUTS_BENCH = dict(n=24, d=10, chains=64, num_warmup=128, num_samples=128, thinning=8)
NUTS_ACCEPT = (0.5, 0.98)
NUTS_MAX_DIVERGENCE = 0.10
# card against CPU in one float32 NUTS transition (up to 63 leapfrogs of a
# potential whose K1 and K2 round differently on each side): the tree's
# depth, leaves and divergence equal, max |z difference| and the
# potential's relative difference
NUTS_STEP_TOL = {"z": 1e-3, "pe_rel": 1e-4}
# constrained optimization (ROADMAP item 17): the ConstrainedGramacy loop
# (Gramacy et al. 2016, negated to maximize: best reachable -0.5998; 10
# Sobol points, 20 iterations, capacity 30) and Hartmann-6 under the known
# linear constraint sum(x) <= 3 (BoTorch's closed-loop constrained
# tutorial's ||x||_1 <= 3; the optimum sums to 2.07), 10 polytope points
# and 12 iterations (capacity 22); both at config 1's budgets
GRAMACY_OPT = 0.5998
GRAMACY_LOOP = dict(n_init=10, iterations=20)
GRAMACY_LOWER = (-math.inf, 0.0, 0.0)  # the objective, then both slacks >= 0
HARTMANN_LOOP = dict(n_init=10, iterations=12)
HARTMANN_SUM_LE_3 = [(tuple(range(6)), (-1.0,) * 6, -3.0)]
# card against CPU in one constrained `optimize_acqf` from the same fit
# starts and initial conditions: max |candidate difference| and the value's
# |difference| / max(1, |value|), as `MC_STEP_TOL`; a candidate that moves
# further (a flat optimum: the inter-point budget's is a whole face) must
# score as high under the CPU's acquisition, within the same tolerance
CONSTRAINED_STEP_TOL = 2e-2
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32 /
# float64 operations per second outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "float64": 34e12}
# Kernel-vs-plain tolerances (max |kernel - plain| <= atol + rtol * max |plain|).
# float32: both sides round differently in sums of ~n terms; Kinv and dK
# carry the condition number (< 10 for the K1 test matrices).
K1_TOL = {"float32": (1e-5, 2e-5), "float64": (1e-12, 1e-11)}
K1_OUTPUTS = ("quad", "logdet", "alpha", "kinv")
# K2 is held to its plain version evaluated in float64 on the same inputs.
# The plain version expands d2 = |xs|^2 + |zs|^2 - 2 xs.zs,
# whose cancellation keeps rounding steps of |xs|^2 (up to ~1e3 here):
# in float32 that version is itself off by more than 1e-5 at the wider
# inputs (`plain_max_abs_err` of each case). K2 sums d2 from the
# differences, a few rounding steps of d2 itself, well inside 1e-5.
# matern12 = exp(-r) with r = sqrt(d2) has unit slope at r = 0: at
# coincident points K2 gives d2 = 0 exactly while the float64 expansion
# leaves ~1e-14, i.e. ~1e-7 in the output (the float64 bound). At d = 6
# (config 2) |xs|^2 reaches ~600 and the expansion leaves up to ~1e-13 at
# coincident points, ~4e-7 in the output: there the float64 bound is 1e-6.
K2_ATOL = {
    "float32": {"rbf": 1e-5, "matern52": 1e-5, "matern32": 1e-5, "matern12": 2e-3},
    "float64": {"rbf": 1e-12, "matern52": 1e-12, "matern32": 1e-12, "matern12": 1e-7},
}
K2_ATOL_F64_MATERN12_COINCIDENT_WIDE = 1e-6  # d > 2
# K2's gradients (x, z, lengthscale) against autograd of the plain version,
# as (atol, rtol) of max |grad - ref| <= atol + rtol * max |ref|. The op's
# backward is itself autograd of the plain version, so today this holds
# only its wiring (the saved inputs, `needs_input_grad`), not CUDA code;
# the tolerances are set for a backward kernel, whose sums of up to n or m
# products of O(max |ref|) terms would round in another order: rtol 1e-5
# in float32, 1e-11 in float64. matern12 at coincident points has its own:
# its derivative in d2 is exp(-r) / (2 r), so the ~1e-7 cancellation error
# of the plain version's float32 d2 next to the diagonal grows to ~1e-3
# relative there.
K2_GRAD_TOL = {
    "float32": {"smooth": (1e-6, 1e-5), "matern12_coincident": (1e-6, 2e-3)},
    "float64": {"smooth": (1e-14, 1e-11), "matern12_coincident": (1e-14, 1e-7)},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


class ClockSampler:
    """Samples `nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit`
    every 100 ms while a phase runs; `summary()` gives the SM clock (MHz)
    and power draw (W) seen, with the limit. The sampler is stopped on exit."""

    QUERY = "--query-gpu=clocks.sm,power.draw,power.limit"

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", self.QUERY, "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.rows = []
        for line in out.splitlines():
            try:
                self.rows.append([float(v) for v in line.split(",")[:3]])
            except ValueError:
                continue
        return False

    def summary(self) -> dict:
        if not self.rows:
            return {"samples": 0}
        clk, draw, limit = zip(*self.rows)
        return {"samples": len(self.rows), "sm_mhz_min": min(clk), "sm_mhz_max": max(clk),
                "sm_mhz_median": sorted(clk)[len(clk) // 2], "power_w_max": max(draw),
                "power_limit_w": limit[0]}


def time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Milliseconds per call between CUDA events around `reps` calls: the
    host-inclusive cost of a call (Python, wrapper, launch) when that is
    longer than the device work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps: int = 1, cpu: bool = True) -> dict:
    """`{kernel name: (launches, device microseconds)}` of `reps` calls of
    `fn`, from `torch.profiler`'s CUDA activity (with its CPU activity too
    unless `cpu` is false, which costs less for a long call). The device
    events are summed from the profiler's raw event list: `key_averages()`
    takes minutes over the ~10^6 launches of a SAASBO step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.profiler.kineto_results.events():
        # CPU ops carry their kernels' time too: keep the device events only
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        us = e.duration_ns() / 1e3
        if us > 0:
            count, total = rows.get(e.name(), (0, 0.0))
            rows[e.name()] = (count + 1, total + us)
    return rows


def device_ms(fn, reps: int = 50) -> tuple[float, str]:
    """Device milliseconds per call (every kernel the call launches), from
    the profiler; CUDA events around the calls if the profiler sees no
    device time."""
    for _ in range(5):
        fn()
    rows = device_profile(fn, reps)
    total_us = sum(us for _, us in rows.values())
    if total_us > 0:
        return total_us / reps / 1e3, "profiler"
    return time_ms(fn, reps), "events"


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def within(err: float, ref, atol: float, rtol: float = 0.0) -> bool:
    return math.isfinite(err) and err <= atol + rtol * float(ref.double().abs().max())


def timings(kernel, plain, library) -> dict:
    """Device time per call of the kernel's wrapper, its plain version and
    the library yardstick (`*_ms`), and the host-inclusive call time of the
    wrapper and the plain version (`*call_ms`)."""
    ms, how = device_ms(kernel)
    plain_ms, _ = device_ms(plain)
    # the library yardstick is the median of three profiles: one profile in
    # a run once caught a fraction of cuSOLVER's kernels
    library_ms = None if library is None else sorted(device_ms(library)[0] for _ in range(3))[1]
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "timing": how, "call_ms": time_ms(kernel), "plain_call_ms": time_ms(plain),
    }


def floor_ms() -> float:
    """Device time of `add_` on a one-element CUDA tensor: the shortest
    kernel this card runs, the floor under every small launch."""
    import torch

    t = torch.zeros(1, device="cuda")
    return device_ms(lambda: t.add_(1.0), reps=200)[0]


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------- #
def phase_build():
    from botorch_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    cuda_build.load("mvn_quad_logdet")
    cuda_build.load("kernel_matrix")
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "sources": list(cuda_build.KERNEL_SOURCES), "gpu": smi_line()}


def _spd(B, n, dtype, gen):
    import torch

    A = torch.randn(B, n, n, generator=gen, dtype=torch.float64)
    K = A @ A.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64)
    r = torch.randn(B, n, generator=gen, dtype=torch.float64)
    return K.to(dtype).cuda(), r.to(dtype).cuda()


def k1_case(B, n, dtype, gen, floor):
    import torch

    from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet, qd_cuda, qd_plain

    name = str(dtype).split(".")[-1]
    K, r = _spd(B, n, dtype, gen)
    errs, ok = {}, True
    atol, rtol = K1_TOL[name]
    got = qd_cuda(K, r)
    ref = qd_plain(K, r)
    for key, a, b in zip(K1_OUTPUTS, got, ref):
        errs[key] = max_err(a, b)
        ok &= within(errs[key], b, atol, rtol)
    symmetric = bool((got[3] == got[3].transpose(-1, -2)).all())
    ok &= symmetric
    # backward: the kernel's closed form against autograd of the plain version
    Kg = K.clone().requires_grad_(True)
    rg = r.clone().requires_grad_(True)
    q, ld = mvn_quad_logdet(Kg, rg)
    dK, dr = torch.autograd.grad((q + 0.5 * ld).sum(), (Kg, rg))
    Kp = K.clone().requires_grad_(True)
    rp = r.clone().requires_grad_(True)
    qp, ldp, _, _ = qd_plain(Kp, rp)
    dKp, drp = torch.autograd.grad((qp + 0.5 * ldp).sum(), (Kp, rp))
    # autograd of the plain Cholesky gives an unsymmetrized dK; compare the
    # symmetric part, which is what every symmetric perturbation of K sees
    dKp = 0.5 * (dKp + dKp.transpose(-1, -2))
    errs["dK"] = max_err(dK, dKp)
    errs["dr"] = max_err(dr, drp)
    ok &= within(errs["dK"], dKp, atol, rtol) and within(errs["dr"], drp, atol, rtol)

    def library():
        L, _ = torch.linalg.cholesky_ex(K)
        return torch.cholesky_solve(r[..., None], L)

    case = {
        "B": B, "n": n, "dtype": name, "max_abs_err": errs, "atol": atol, "rtol": rtol,
        "kinv_symmetric": symmetric, "ok": bool(ok),
        **timings(lambda: qd_cuda(K, r), lambda: qd_plain(K, r), library), "floor_ms": floor,
    }
    case["vs_library"] = case["ms"] / case["library_ms"]
    isz = K.element_size()
    # reads K and r, writes quad, logdet, alpha and Kinv
    nbytes = isz * B * (2 * n * n + 2 * n + 2)
    # Cholesky n^3/3 multiply-adds, L^-1 n^3/6, Kinv n^3/6, w and alpha n^2
    ops = B * (4 * n**3 / 3 + 2 * n * n + 2 * n)
    case["bound_ms"], case["bound_by"] = bound_ms(nbytes, ops, name)
    return case


# the last two fill every SM with more than one matrix's block
# (8, 26), (8, 15) and (64, 24): config 3's NUTS potential at its capacity
# and at the saasbo_loop phase's, and `bench.py`'s NUTS throughput shape; (2, 40): config 5's exact TuRBO fit; (2, 30) and (2, 22):
# the constrained loops' fits (Gramacy, each of its 3 outputs; Hartmann-6)
K1_SHAPES = ((7, 13), (32, 24), (8, 64), (2, 35)) + tuple(
    (B, n) for B in (1, 5, 33) for n in (1, 31, 32, 33)) + ((200, 35), (200, 64), (8, 26), (64, 24),
                                                            (2, 40), (2, 30), (2, 22),
                                                            (8, SAASBO_LOOP_CAPACITY))


def k1_nan_member_case(B, n, gen) -> dict:
    """K1 on a float32 batch whose middle matrix is not positive definite,
    as a divergent leapfrog gives: NaN quad and logdet for it, the other
    matrices within tolerance of the plain version, and no raise."""
    import torch

    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda, qd_plain

    K, r = _spd(B, n, torch.float32, gen)
    bad = B // 2
    K[bad, 3, 3] = -1.0
    got = qd_cuda(K, r)
    torch.cuda.synchronize()
    keep = [i for i in range(B) if i != bad]
    ref = qd_plain(K[keep], r[keep])
    atol, rtol = K1_TOL["float32"]
    errs = {key: max_err(a[keep], b) for key, a, b in zip(K1_OUTPUTS, got, ref)}
    nan = bool(torch.isnan(got[0][bad]) and torch.isnan(got[1][bad]))
    ok = nan and all(within(errs[key], b, atol, rtol) for key, b in zip(K1_OUTPUTS, ref))
    return {"B": B, "n": n, "dtype": "float32", "bad_member": bad, "bad_is_nan": nan,
            "max_abs_err": errs, "ok": bool(ok)}


def k1_op_kernels() -> dict:
    """The device kernels of one forward and backward of the differentiable
    op at the fit's shape: K1 alone forward (it writes Kinv), elementwise
    kernels backward, and no GEMM anywhere."""
    import torch

    from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet

    K, r = _spd(2, 35, torch.float32, torch.Generator().manual_seed(1))
    Kg = K.clone().requires_grad_(True)

    def fwd():
        return mvn_quad_logdet(Kg.detach(), r)

    def fwd_bwd():
        q, ld = mvn_quad_logdet(Kg, r)
        torch.autograd.grad((q + ld).sum(), Kg)

    names = {label: sorted(device_profile(fn, 3)) for label, fn in (("forward", fwd), ("forward_backward", fwd_bwd))}
    ok = (len(names["forward"]) == 1 and "mvn_qd_kernel" in names["forward"][0]
          and not any("gemm" in k.lower() for k in names["forward_backward"]))
    return {"ok": bool(ok), **names}


def phase_k1(gen):
    import torch

    with ClockSampler() as clocks:
        floor = floor_ms()
        cases = [
            k1_case(B, n, dtype, gen, floor)
            for dtype in (torch.float32, torch.float64)
            for (B, n) in K1_SHAPES
        ]
        op = k1_op_kernels()
        nan_member = [k1_nan_member_case(B, n, gen) for B, n in ((8, 26), (64, 24))]
    ok = all(c["ok"] for c in cases + nan_member) and op["ok"]
    return {"phase": "k1", "ok": ok, "floor_ms": floor, "clocks": clocks.summary(),
            "op_kernels": op, "nan_member": nan_member, "cases": cases}


def k2_path_params(path: str, B: int, n: int, m: int, d: int, dtype, num_sms: int) -> tuple:
    """The two path parameters of K2's C entry point for `path`, as
    `k2_plan` sets them when it picks that path (the narrow launcher takes
    any n * m)."""
    from botorch_tpu_torch.ops.kernel_matrix import TILE_COLS, TILE_ROWS_PER_THREAD

    if path == "narrow":
        return (2 if d <= 2 else 8 if d <= 8 else 32, 128)
    for rm in TILE_ROWS_PER_THREAD:
        if math.ceil(m / TILE_COLS) * math.ceil(n / (16 * rm)) * B >= num_sms:
            break
    return (rm, int(m % (16 // dtype.itemsize) == 0))


def k2_paths_ms(x, z, ls, kind, ref) -> dict:
    """Both K2 paths launched through their C entry points on the same
    inputs (`x (n, d)` shared or `(B, n, d)`, `z (B, m, d)`, `ls (B, d)`,
    all contiguous): device ms of each and its max |error| against `ref`."""
    import torch

    from botorch_tpu_torch.ops import cuda_build
    from botorch_tpu_torch.ops.kernel_matrix import _KIND, _functions

    B, m, d = z.shape
    n = x.shape[-2]
    sx = 0 if x.ndim == 2 else n * d
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    row = {}
    for path in ("narrow", "tiled"):
        out = torch.empty((B, n, m), dtype=x.dtype, device=x.device)
        args = (x.data_ptr(), z.data_ptr(), ls.data_ptr(), out.data_ptr(), B, n, m, d,
                sx, m * d, d, _KIND[kind], *k2_path_params(path, B, n, m, d, x.dtype, num_sms),
                stream)

        def launch(fn=_functions()[path, x.dtype], args=args):
            cuda_build.check(fn(*args), f"kernel_matrix {path}")

        launch()
        row[f"{path}_max_abs_err"] = max_err(out, ref)
        row[f"{path}_ms"], row[f"{path}_timing"] = device_ms(launch)
    return row


def k2_case(B, n, m, d, coincident, kind, dtype, gen, floor, both_paths=False):
    """One K2 case. `coincident`: None (x (n, d) shared by the batch, z
    (B, m, d)), "shared" (z = x, shared: a train covariance) or "batched"
    (z = x, (B, n, d): the acquisition's joint covariance). `both_paths`
    also times the narrow and the tiled kernel on the same inputs."""
    import torch

    from botorch_tpu_torch.ops.kernel_matrix import (
        k2_plan, kernel_matrix, kernel_matrix_cuda, kernel_matrix_plain,
    )

    name = str(dtype).split(".")[-1]
    kw = dict(generator=gen, dtype=torch.float64)
    # the main path shares the train inputs and scales them per restart
    x = torch.rand(*((B,) if coincident == "batched" else ()), n, d, **kw).to(dtype).cuda()
    z = x if coincident else torch.rand(B, m, d, **kw).to(dtype).cuda()
    ls = (0.1 + torch.rand(B, d, **kw)).to(dtype).cuda()
    out = kernel_matrix_cuda(x, z, ls, kind)
    ref = kernel_matrix_plain(x.double(), z.double(), ls.double(), kind)
    atol = K2_ATOL[name][kind]
    if (name, kind) == ("float64", "matern12") and coincident and d > 2:
        atol = K2_ATOL_F64_MATERN12_COINCIDENT_WIDE
    err = max_err(out, ref)
    plain_err = max_err(kernel_matrix_plain(x, z, ls, kind), ref)
    ok = within(err, ref, atol) and out.shape == ref.shape and out.dtype == dtype
    # backward: the op's gradients against autograd of the plain version
    g = torch.randn(ref.shape, **kw).to(dtype).cuda()
    inputs = [t.clone().requires_grad_(True) for t in (x, z, ls)]
    grads = torch.autograd.grad(kernel_matrix(*inputs, kind), inputs, g)
    inputs_p = [t.clone().requires_grad_(True) for t in (x, z, ls)]
    grads_p = torch.autograd.grad(kernel_matrix_plain(*inputs_p, kind), inputs_p, g)
    gtol = K2_GRAD_TOL[name]["matern12_coincident" if kind == "matern12" and coincident else "smooth"]
    gerr = {}
    for key, a, b in zip(("x", "z", "lengthscale"), grads, grads_p):
        gerr[key] = max_err(a, b)
        ok &= within(gerr[key], b, *gtol)
    plan = k2_plan(B, n, m, d, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    case = {
        "B": B, "n": n, "m": m, "d": d, "kind": kind, "dtype": name,
        "coincident": coincident, "path": plan["path"], "max_abs_err": err,
        "plain_max_abs_err": plain_err, "grad_max_abs_err": gerr, "atol": atol, "grad_tol": gtol,
        **timings(lambda: kernel_matrix_cuda(x, z, ls, kind),
                  lambda: kernel_matrix_plain(x, z, ls, kind), None),
        "floor_ms": floor,
    }
    if both_paths:
        paths = k2_paths_ms(x, z.expand(B, m, d).contiguous(), ls, kind, ref)
        case.update(paths)
        ok &= all(within(paths[f"{p}_max_abs_err"], ref, atol) for p in ("narrow", "tiled"))
    case["ok"] = bool(ok)
    case["vs_floor"] = case["ms"] / floor
    isz = x.element_size()
    nbytes = isz * (x.numel() + (0 if coincident else z.numel()) + ls.numel() + B * n * m)
    ops = B * (2 * n * m * d + 2 * (n + m) * d + 9 * n * m)
    case["bound_ms"], case["bound_by"] = bound_ms(nbytes, ops, name)
    return case


# (B, n, m, d, coincident): the config-1 loop's fit covariance and
# `train_chol`'s (z = x), a large tiled shape, the acquisition's k(X, x)
# and k(x, x) for the 6 restarts and the 64 raw points (as a profiled step
# launches them), the same at 80 points, and wider feature counts; then
# the config-2 qLogNEI loop's: the fit's and `train_chol`'s covariance of
# 76 padded rows, and k(X_train, X_full), k(X_full, X_full) over 76
# baseline + 4 candidate points for the 64 raw q-batches and the 6 restarts
CONFIG2_K2 = ((2, 76, 76, 6, "shared"), (1, 76, 76, 6, "shared"), (64, 76, 80, 6, None),
              (64, 80, 80, 6, "batched"), (6, 76, 80, 6, None), (6, 80, 80, 6, "batched"))
# config 3's (matern52): the NUTS potential's covariance of 26 padded rows
# (the config's capacity) and of 15 (the saasbo_loop phase's) for 8 chains,
# the ensemble `train_chol`'s for 16 members, k(x_train, X) and k(X, X) of
# the ensemble LogEI at the 512 raw points and 32 restarts (times 16
# members), and the NUTS throughput shape's covariance
CONFIG3_K2 = tuple((B, n, m, 8, c) for n in (26, SAASBO_LOOP_CAPACITY)
                   for B, m, c in ((8, n, "shared"), (16, n, "shared"), (8192, 1, None),
                                   (512, 1, None)))
CONFIG3_K2 += ((8192, 1, 1, 8, "batched"), (512, 1, 1, 8, "batched"), (64, 24, 24, 10, "shared"))
# config 4's (rbf, d = 2): the fit's covariance of 90 padded rows for its 2
# restarts and `train_chol`'s (each once per output), and the joint
# posterior of the 90 baseline rows and the 1-4 sequential-greedy points,
# k(x_train, X_full) and k(X_full, X_full), for the 32 raw points of pick 0
# and the 4 restarts of pick 3
CONFIG4_K2 = ((2, 90, 90, 2, "shared"), (1, 90, 90, 2, "shared"), (32, 90, 91, 2, None),
              (32, 91, 91, 2, "batched"), (4, 90, 94, 2, None), (4, 94, 94, 2, "batched"))
# config 5's: the SVGP's (d = 20, one unbatched problem each) Kzz (256 x
# 256), Kzx (256 x 512) and Kxx (512 x 512) of a minibatch, its paths' Kxz
# at 2048 candidates and the greedy pivots' column over the loop's four
# history sizes (16384 + 64 i, 1), matern52; the exact GP's paths at 4096
# candidates (4096 x 2048) and its train covariance (2048 x 2048), rbf;
# the exact Ackley-4 loop's (rbf, d = 4): its fit's covariance of 40
# padded rows for 2 restarts and `train_chol`'s, and its paths' k(Xc, X)
# at 256 candidates
CONFIG5_K2 = (((1, 256, 256, 20, "shared"), "matern52"), ((1, 256, 512, 20, None), "matern52"),
              ((1, 512, 512, 20, "shared"), "matern52"), ((1, 2048, 256, 20, None), "matern52"),
              ((1, 16384, 1, 20, None), "matern52"), ((1, 16448, 1, 20, None), "matern52"),
              ((1, 16512, 1, 20, None), "matern52"), ((1, 16576, 1, 20, None), "matern52"),
              ((1, 4096, 2048, 20, None), "rbf"), ((1, 2048, 2048, 20, "shared"), "rbf"),
              ((2, 40, 40, 4, "shared"), "rbf"), ((1, 40, 40, 4, "shared"), "rbf"),
              ((1, 256, 40, 4, None), "rbf"))
# the constrained loops' (rbf): ConstrainedGramacy's (d = 2, 30 padded rows)
# fit and `train_chol` covariances for its 2 restarts and once, and the
# LogCEI's k(x_train, X) and k(X, X) for the 6 restarts and the 64 raw
# points; the same for Hartmann-6 under sum(x) <= 3 (d = 6, 22 rows)
CONSTRAINED_K2 = tuple(
    ((B, n, m, d, c), "rbf") for n, d in ((30, 2), (22, 6))
    for B, m, c in ((2, n, "shared"), (1, n, "shared"), (6, 1, None), (64, 1, None)))
CONSTRAINED_K2 += tuple(((B, 1, 1, d, "batched"), "rbf") for d in (2, 6) for B in (6, 64))
K2_SHAPES = ((2, 35, 35, 2, "shared"), (1, 35, 35, 2, "shared"), (1, 300, 257, 7, None),
             (6, 35, 1, 2, None), (6, 1, 1, 2, None), (64, 35, 1, 2, None), (64, 1, 1, 2, None),
             (80, 35, 1, 2, None), (80, 1, 1, 2, None), (1, 64, 48, 8, None),
             (1, 64, 48, 20, None)) + CONFIG2_K2


def k2_op_launches() -> dict:
    """Device launches of the op's forward (K2 alone) and of its backward
    (autograd of the plain version), rbf float32: at the config-1 fit's
    (2, 35, 35, 2), gradients in x and the lengthscales, and at the config-2
    ascent's k(X_train, X_full) (6, 76, 80, 6), gradients in the candidates."""
    import torch

    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix

    def count(x, z, ls, wrt):
        def fwd():
            return kernel_matrix(x, z, ls, "rbf")

        g = torch.ones_like(fwd())

        def fwd_bwd():
            torch.autograd.grad(fwd(), wrt, g)

        fwd_bwd()  # warm-up: a profile can miss the first launches of a new call
        forward = sum(c for c, _ in device_profile(fwd).values())
        both = sum(c for c, _ in device_profile(fwd_bwd).values())
        return {"forward": forward, "backward": both - forward}

    x = torch.rand(35, 2, device="cuda", requires_grad=True)
    ls = torch.full((2, 2), 0.5, device="cuda", requires_grad=True)
    x_train = torch.rand(76, 6, device="cuda")
    x_full = torch.rand(6, 80, 6, device="cuda", requires_grad=True)
    return {"fit_2x35x35x2": count(x, x, ls, (x, ls)),
            "ascent_6x76x80x6": count(x_train, x_full, torch.full((6,), 0.5, device="cuda"),
                                      (x_full,))}


def k2_config_cases(table, dtypes, gen, floor) -> list:
    """K2's cases at a config's ((B, n, m, d, coincident), kind) table in
    each of `dtypes`, both paths timed."""
    return [k2_case(*shape, kind, dtype, gen, floor, both_paths=True)
            for dtype in dtypes for shape, kind in table]


def phase_k2(gen):
    import torch

    cases = []
    with ClockSampler() as clocks:
        floor = floor_ms()
        for dtype in (torch.float32, torch.float64):
            for kind in ("rbf", "matern52", "matern32", "matern12"):
                for shape in K2_SHAPES:
                    both = kind == "rbf" and shape in CONFIG2_K2
                    cases.append(k2_case(*shape, kind, dtype, gen, floor, both_paths=both))
            for shape in CONFIG3_K2:
                cases.append(k2_case(*shape, "matern52", dtype, gen, floor))
        cases += k2_config_cases([(s, "rbf") for s in CONFIG4_K2],
                                 (torch.float32, torch.float64), gen, floor)
        cases += k2_config_cases(CONFIG5_K2, (torch.float32,), gen, floor)
        cases += k2_config_cases(CONSTRAINED_K2, (torch.float32, torch.float64), gen, floor)
    return {"phase": "k2", "ok": all(c["ok"] for c in cases), "floor_ms": floor,
            "clocks": clocks.summary(), "op_launches": k2_op_launches(), "cases": cases}


def phase_bo_step():
    """One step on a 12-point Branin history, on the card and on the CPU
    (plain versions), from the same restart starts and initial conditions."""
    import torch

    from botorch_tpu_torch.fit import _prepare_fit
    from botorch_tpu_torch.loop import BOState, _bo_step, init_state
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.sampling.sobol import sobol_table
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.synthetic import Branin
    from botorch_tpu_torch.utils.transforms import unnormalize

    prob = Branin(negate=True)
    state, X0 = init_state(12, 2, 20, seed=3, device="cpu")
    Y = torch.zeros(20)
    Y[:12] = prob(unnormalize(X0, prob.bounds))
    state = BOState(X=state.X, Y=Y, n=12)
    mask = torch.arange(20) < 12
    model = make_gp(state.X, state.Y[:, None], mask=mask, device="cpu")
    _, _, x0, _, _ = _prepare_fit(model, make_generator(1, "cpu"), 2)
    ics = torch.rand(6, 1, 2, generator=make_generator(2, "cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        st = BOState(X=state.X.to(dev), Y=state.Y.to(dev), n=12)
        sob = sobol_table(2, seed=3, device=dev)
        cand, val, params = _bo_step(
            st, sob, make_generator(0, dev), num_restarts=6, raw_samples=64,
            fit_restarts=2, fit_maxiter=15, acq_maxiter=15,
            fit_x0=x0, initial_conditions=ics,
        )
        out[dev] = (cand.cpu(), val.cpu(), params.raw_lengthscale.cpu(), params.raw_noise.cpu())
    errs = {k: max_err(a, b) for k, a, b in zip(
        ("candidate", "value", "raw_lengthscale", "raw_noise"), out["cuda"], out["cpu"])}
    # Both sides run the same L-BFGS in float32 with differently rounded
    # kernels; 15 fit iterations and 15 ascent iterations keep the paths
    # together to ~1e-3 on this well-separated problem.
    ok = all(math.isfinite(e) and e < 2e-2 for e in errs.values())
    return {"phase": "bo_step", "ok": bool(ok), "max_abs_err": errs, "tol": 2e-2}


def phase_bo_loop():
    import torch

    from botorch_tpu_torch.loop import best_observed, run_bo_loop
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.test_functions.synthetic import Branin
    from botorch_tpu_torch.utils.transforms import unnormalize

    prob = Branin(negate=True)

    def objective(X):
        return prob(unnormalize(X, prob.bounds))

    # warm-up (library handles, allocator), then the counted, timed run
    run_bo_loop(objective, d=2, n_init=10, iterations=2, seed=1, **LOOP_CFG)
    torch.cuda.synchronize()
    qd_cuda.launches = 0
    kernel_matrix_cuda.launches = 0
    t0 = time.perf_counter()
    state = run_bo_loop(objective, d=2, n_init=10, iterations=25, seed=0, **LOOP_CFG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mvn_quad_logdet": qd_cuda.launches, "kernel_matrix": kernel_matrix_cuda.launches}
    regret = -float(best_observed(state)) - BRANIN_OPT
    X = state.X[: state.n]
    shape_ok = state.X.shape == (35, 2) and state.n == 35 and state.X.is_cuda
    finite = bool(torch.isfinite(state.Y[: state.n]).all() and torch.isfinite(X).all())
    in_box = bool(((X >= 0) & (X <= 1)).all())
    ok = (shape_ok and finite and in_box and regret < REGRET_BAR
          and all(v > 0 for v in launches.values()))
    return {
        "phase": "bo_loop", "ok": bool(ok), "wall_s": wall, "iterations": 25,
        "iters_per_s": 25 / wall, "regret": regret, "regret_bar": REGRET_BAR,
        "launches": launches, "shape_ok": shape_ok, "finite": finite, "in_box": in_box,
        "last_step": step_breakdown(state, 1, LOOP_CFG),
    }


def phase_mc_step():
    """One qLogNEI step at the padded config-2 state after the initial
    design (16 Hartmann-6 points in 76 rows), on the card and on the CPU
    (plain versions), from the same fit starts, initial conditions and base
    samples; with the jitter rung `psd_safe_cholesky` takes for the joint
    posterior of the 76 baseline rows and the 4 candidates on each side."""
    import torch

    from botorch_tpu_torch.acquisition.monte_carlo import draw_fresh_base_samples
    from botorch_tpu_torch.fit import _prepare_fit
    from botorch_tpu_torch.loop import BOState, _bo_step, append_observations, init_state
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.ops.chol import jitter_rung
    from botorch_tpu_torch.sampling.sobol import sobol_table
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.synthetic import Hartmann

    d, q, n0 = CONFIG2["d"], CONFIG2["q"], CONFIG2["n_init"]
    cap = n0 + CONFIG2["iterations"] * q
    state, X0 = init_state(n0, d, cap, seed=0, device="cpu")
    state = append_observations(state, X0, Hartmann(dim=d, negate=True)(X0))
    mask = torch.arange(cap) < n0
    model = make_gp(state.X, state.Y[:, None], mask=mask, device="cpu")
    _, _, x0, _, _ = _prepare_fit(model, make_generator(1, "cpu"), QNEI_CFG["fit_restarts"])
    ics = torch.rand(QNEI_CFG["num_restarts"], q, d, generator=make_generator(2, "cpu"))
    base = draw_fresh_base_samples(cap + q, 1, QNEI_CFG["mc_samples"], make_generator(3, "cpu"),
                                   seed=17)
    out = {}
    for dev in ("cpu", "cuda"):
        st = BOState(X=state.X.to(dev), Y=state.Y.to(dev), n=n0)
        cand, val, params = _bo_step(
            st, sobol_table(q * d, seed=0, device=dev), make_generator(0, dev), q=q,
            fit_x0=x0, initial_conditions=ics, base_samples=base, **QNEI_CFG,
        )
        fitted = make_gp(st.X, st.Y[:, None], mask=mask.to(dev), device=dev).replace(params=params)
        cov = fitted.posterior(torch.cat([st.X, cand])[None]).cov
        out[dev] = {"candidate": cand.cpu(), "value": float(val),
                    "rung": int(jitter_rung(cov, batch_dims=1)[0])}
    cand_err = max_err(out["cuda"]["candidate"], out["cpu"]["candidate"])
    val_err = abs(out["cuda"]["value"] - out["cpu"]["value"]) / max(1.0, abs(out["cpu"]["value"]))
    c = out["cuda"]["candidate"]
    # Both sides run the same float32 L-BFGS from the same starts; the
    # kernels and the Cholesky factorizations round differently.
    ok = (math.isfinite(cand_err) and cand_err <= MC_STEP_TOL and val_err <= MC_STEP_TOL
          and bool(((c >= 0) & (c <= 1)).all()))
    return {"phase": "mc_step", "ok": bool(ok), "candidate_max_abs_err": cand_err,
            "value_rel_err": val_err, "tol": MC_STEP_TOL,
            "value": {k: v["value"] for k, v in out.items()},
            "rung": {k: v["rung"] for k, v in out.items()}}


def phase_qnei_loop():
    """Config 2 through `run_bo_loop` at `bench.py`'s budgets, seed 0, with
    both kernels' launch counts over the run, K2's by shape and path (the
    counting wrapper adds one Python call per K2 launch to the timed run),
    and one profiled step at the last history size."""
    import torch

    from botorch_tpu_torch.loop import best_observed, run_bo_loop
    from botorch_tpu_torch.ops import kernel_matrix as km
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.test_functions.synthetic import Hartmann

    prob = Hartmann(dim=CONFIG2["d"], negate=True)
    cap = CONFIG2["n_init"] + CONFIG2["iterations"] * CONFIG2["q"]
    # warm-up at the same shapes, then the counted, timed run
    run_bo_loop(prob, **dict(CONFIG2, iterations=1), capacity=cap, seed=1, **QNEI_CFG)
    torch.cuda.synchronize()
    qd_cuda.launches = 0
    km.kernel_matrix_cuda.launches = 0
    run = {}
    t0 = time.perf_counter()
    k2_shapes = k2_shapes_of(lambda: run.update(state=run_bo_loop(prob, **CONFIG2, seed=0,
                                                                  **QNEI_CFG)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state = run["state"]
    launches = {"mvn_quad_logdet": qd_cuda.launches, "kernel_matrix": km.kernel_matrix_cuda.launches}
    by_path = {}
    for row in k2_shapes:
        by_path[row["path"]] = by_path.get(row["path"], 0) + row["launches"]
    n0 = CONFIG2["n_init"]
    regret = HARTMANN6_OPT - float(best_observed(state))
    initial_regret = HARTMANN6_OPT - float(state.Y[:n0].max())
    X = state.X[: state.n]
    shape_ok = state.X.shape == (cap, CONFIG2["d"]) and state.n == cap and state.X.is_cuda
    finite = bool(torch.isfinite(state.Y[: state.n]).all() and torch.isfinite(X).all())
    in_box = bool(((X >= 0) & (X <= 1)).all())
    ok = (shape_ok and finite and in_box and regret < initial_regret
          and launches["kernel_matrix"] > 0)
    iters = CONFIG2["iterations"]
    return {
        "phase": "qnei_loop", "ok": bool(ok), "wall_s": wall, "iterations": iters,
        "iters_per_s": iters / wall, "regret": regret, "initial_design_regret": initial_regret,
        "launches": launches, "kernel_matrix_by_path": by_path,
        "kernel_matrix_shapes": k2_shapes, "shape_ok": shape_ok, "finite": finite,
        "in_box": in_box, "last_step": step_breakdown(state, CONFIG2["q"], QNEI_CFG),
    }


def _branin_embedded():
    """Config 3's objective: Branin on dims 0 and 1 of the unit cube, the
    other dims distractors; maximized."""
    from botorch_tpu_torch.test_functions.synthetic import Branin
    from botorch_tpu_torch.utils.transforms import unnormalize

    prob = Branin(negate=True)
    return lambda X: prob(unnormalize(X[:, :2], prob.bounds))


def phase_nuts_step():
    """One NUTS transition of 8 chains at config 3's first iteration (the
    10-point Sobol design of seed 0 in 26 padded rows, d = 8; step size
    0.1 and the identity mass factor, as a fit starts) on the fit's
    potential and closed-form gradient, on the card and on the CPU (plain
    versions) from the same chain starts and draws."""
    import torch

    from botorch_tpu_torch.models.fully_bayesian import (
        init_saas_chains,
        make_saas_potential_and_grad,
    )
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.sampling import nuts
    from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table
    from botorch_tpu_torch.settings import make_generator

    d, n0 = CONFIG3["d"], CONFIG3["n_init"]
    cap = n0 + CONFIG3["iterations"]
    chains, depth = SAASBO_CFG["num_chains"], SAASBO_CFG["max_depth"]
    sv, shift = sobol_table(d, scramble=True, seed=0, device="cpu")
    X = torch.zeros(cap, d)
    X[:n0] = draw_sobol(sv, shift, n0)
    Y = torch.zeros(cap)
    Y[:n0] = _branin_embedded()(X[:n0])
    mask = torch.arange(cap) < n0
    gen = make_generator(0, "cpu")
    z0 = init_saas_chains(gen, chains, d, True)
    draws = nuts.draw_transition(gen, chains, z0.shape[1], depth, torch.float32, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        base = make_gp(X, Y, kernel="matern52", use_outputscale=True, mask=mask, device=dev)
        pg = nuts.safe(make_saas_potential_and_grad(base.X, base.Y[:, 0], mask=base.mask))
        k = z0.shape[1]
        z = z0.to(dev)
        pe, g = pg(z)
        z1, pe1, _, st = nuts.nuts_transition(
            pg, z, pe, g, torch.tensor(0.1, device=dev), torch.eye(k, device=dev), depth,
            draws=nuts.TransitionDraws(*(t.to(dev) for t in draws)),
        )
        out[dev] = {"z": z1.cpu(), "pe": pe1.cpu(),
                    **{key: st[key].cpu() for key in ("depth", "num_leaves", "diverging")}}
    same_tree = all(torch.equal(out["cuda"][key], out["cpu"][key])
                    for key in ("depth", "num_leaves", "diverging"))
    z_err = max_err(out["cuda"]["z"], out["cpu"]["z"])
    pe_err = float(((out["cuda"]["pe"] - out["cpu"]["pe"]).abs() / out["cpu"]["pe"].abs()).max())
    ok = same_tree and z_err <= NUTS_STEP_TOL["z"] and pe_err <= NUTS_STEP_TOL["pe_rel"]
    return {"phase": "nuts_step", "ok": bool(ok), "same_tree": same_tree, "z_max_abs_err": z_err,
            "pe_max_rel_err": pe_err, "tol": NUTS_STEP_TOL,
            "depth": out["cuda"]["depth"].tolist(), "num_leaves": out["cuda"]["num_leaves"].tolist()}


def _reset_counts():
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.sampling.nuts import nuts_transition

    qd_cuda.launches = kernel_matrix_cuda.launches = 0
    nuts_transition.transitions = nuts_transition.leapfrogs = nuts_transition.host_reads = 0


def phase_nuts():
    """`fit_saas_gp` at `bench.py:76-99`'s shape, timed from the first call
    to a `synchronize()`: NUTS transitions/s counted as `bench.py` counts
    them (chains x (warmup + max(samples // chains, 8))), the lockstep
    leapfrogs and host reads per transition, and the sampler's statistics."""
    import numpy as np
    import torch

    from botorch_tpu_torch.models.fully_bayesian import fit_saas_gp
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.sampling.nuts import nuts_transition
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.synthetic import Branin
    from botorch_tpu_torch.utils.transforms import unnormalize

    cfg = NUTS_BENCH
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(size=(cfg["n"], cfg["d"])), dtype=torch.float32)
    prob = Branin()
    Y = -prob(unnormalize(X[:, :2], prob.bounds))
    fit = dict(num_samples=cfg["num_samples"], thinning=cfg["thinning"], num_chains=cfg["chains"])
    # warm-up: library handles and the allocator at the same shapes
    fit_saas_gp(X, Y, make_generator(0, "cuda"), num_warmup=2, **dict(fit, num_samples=8))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    model, stats = fit_saas_gp(X, Y, make_generator(1, "cuda"), num_warmup=cfg["num_warmup"], **fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    transitions = cfg["chains"] * (cfg["num_warmup"] + max(cfg["num_samples"] // cfg["chains"], 8))
    steps = nuts_transition.transitions
    accept = float(stats["accept_prob"])
    div = float(stats["divergence_rate"])
    finite = bool(torch.isfinite(model.params.raw_lengthscale).all())
    ok = (NUTS_ACCEPT[0] <= accept <= NUTS_ACCEPT[1] and div <= NUTS_MAX_DIVERGENCE and finite
          and qd_cuda.launches > 0
          and nuts_transition.host_reads <= SAASBO_CFG["max_depth"] * steps)
    return {
        "phase": "nuts", "ok": bool(ok), "wall_s": wall, "transitions": transitions,
        "transitions_per_s": transitions / wall, "lockstep_transitions": steps,
        "leapfrogs_per_transition": nuts_transition.leapfrogs / steps,
        "mean_leaves_per_chain": float(stats["mean_leaves"]),
        "host_reads_per_transition": nuts_transition.host_reads / steps,
        "accept_prob": accept, "accept_bounds": list(NUTS_ACCEPT), "divergence_rate": div,
        "max_divergence_rate": NUTS_MAX_DIVERGENCE, "step_size": float(stats["step_size"]),
        "ensemble_size": model.batch_shape[0], "finite": finite,
        "launches": {"mvn_quad_logdet": qd_cuda.launches,
                     "mvn_quad_logdet_shape": [cfg["chains"], cfg["n"]]},
    }


def phase_saasbo_loop(profile: bool = False):
    """Config 3 through `run_saasbo`, seed 0, at `bench.py`'s budgets, its
    first `SAASBO_LOOP_ITERATIONS` iterations, with K1's and K2's launches
    by shape over
    the run, the NUTS counters, the final regret beside the initial
    design's, the SAAS dimension check of the JAX package's test (the
    median of the two active dims' median lengthscales below the
    distractors'), and with `profile` one profiled step (a timed step and
    a profiled one, 90-150 s on top of the loop: `tools/chip_phases.py
    saasbo_loop_profiled`)."""
    import numpy as np
    import torch

    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.sampling.nuts import nuts_transition
    from botorch_tpu_torch.saasbo import run_saasbo, saasbo_step
    from botorch_tpu_torch.settings import make_generator

    objective = _branin_embedded()
    d, n0, iterations = CONFIG3["d"], CONFIG3["n_init"], SAASBO_LOOP_ITERATIONS
    capacity = SAASBO_LOOP_CAPACITY
    # warm-up: one short step on buffers of the loop's capacity, then the
    # counted, timed run
    Xw = torch.rand(capacity, d, generator=make_generator(1, "cuda"), device="cuda")
    saasbo_step(Xw, objective(Xw), n0, make_generator(1, "cuda"),
                **dict(SAASBO_CFG, num_warmup=4, num_samples=16, acq_maxiter=3))
    torch.cuda.synchronize()
    _reset_counts()
    run = {}
    t0 = time.perf_counter()

    def loop():
        run["res"] = run_saasbo(objective, d=d, n_init=n0, iterations=iterations, seed=0,
                                **SAASBO_CFG)

    k1_shapes = k1_shapes_of(lambda: run.update(k2=k2_shapes_of(loop)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = run["res"]
    regret = -float(res.best_curve[-1]) - BRANIN_OPT
    initial_regret = -float(res.Y[:n0].max()) - BRANIN_OPT
    ml = res.median_lengthscales[-1].cpu().numpy()
    active, distractors = float(np.median(ml[:2])), float(np.median(ml[2:]))
    X = res.X
    finite = bool(torch.isfinite(res.Y).all() and torch.isfinite(X).all())
    in_box = bool(((X >= 0) & (X <= 1)).all())
    steps = nuts_transition.transitions
    main_k1 = [r for r in k1_shapes if (r["B"], r["n"]) == (SAASBO_CFG["num_chains"], capacity)]
    ok = (finite and in_box and X.is_cuda and X.shape == (n0 + iterations, d)
          and regret < initial_regret and active < distractors
          and main_k1 and main_k1[0]["launches"] > 0 and kernel_matrix_cuda.launches > 0)
    out = {
        "phase": "saasbo_loop", "ok": bool(ok), "wall_s": wall, "iterations": iterations,
        "config_iterations": CONFIG3["iterations"], "capacity": capacity,
        "iters_per_s": iterations / wall,
        "regret": regret, "initial_design_regret": initial_regret,
        "median_lengthscales_last": ml.tolist(), "active_median": active,
        "distractor_median": distractors,
        "launches": {"mvn_quad_logdet": qd_cuda.launches, "kernel_matrix": kernel_matrix_cuda.launches},
        "mvn_quad_logdet_shapes": k1_shapes, "kernel_matrix_shapes": run["k2"],
        "nuts": {"lockstep_transitions": steps,
                 "leapfrogs_per_transition": nuts_transition.leapfrogs / max(steps, 1),
                 "host_reads_per_transition": nuts_transition.host_reads / max(steps, 1)},
        "finite": finite, "in_box": in_box,
    }
    if profile:
        out["last_step"] = saasbo_step_breakdown(res)
    return out


def saasbo_step_breakdown(res) -> dict:
    """Wall time of one SAASBO step at the loop's last history size (all
    rows but the last valid, in the loop's buffers) and where its
    device time goes (profiled in a second, identical call; CUDA activity
    only: the profiler's CPU activity over ~10^6 launches costs minutes)."""
    import torch

    from botorch_tpu_torch.saasbo import saasbo_step
    from botorch_tpu_torch.settings import make_generator

    n = res.X.shape[0] - 1
    X, Y = res.X.clone(), res.Y.clone()

    def step():
        return saasbo_step(X, Y, n, make_generator(5, "cuda"), seed=0, **SAASBO_CFG)

    # the loop left the libraries warm: one timed step, one profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows = device_profile(step, cpu=False)
    profile_s = time.perf_counter() - t0
    busy_ms = sum(us for _, us in rows.values()) / 1e3
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]

    def pick(tag):
        hits = [(c, us) for k, (c, us) in rows.items() if tag in k]
        return {"launches": sum(c for c, _ in hits), "device_ms": sum(us for _, us in hits) / 1e3}

    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches": sum(c for c, _ in rows.values()), "profile_s": profile_s,
        "mvn_quad_logdet": pick("mvn_qd_kernel"), "kernel_matrix": pick("kernel_matrix_"),
        "top_kernels": [{"name": k[:80], "launches": c, "device_ms": us / 1e3} for k, (c, us) in top],
    }


def _pick_acqf(model, state, base, ref_point, j, pending):
    """Pick j's qLogNEHVI of a config-4 step (`mo_loop._mo_bo_step`): the
    joint of the padded baseline, one candidate and the j earlier picks."""
    import torch

    from botorch_tpu_torch.acquisition.multi_objective import make_in_graph_nehvi_cells
    from botorch_tpu_torch.mo_loop import _qlognehvi

    cap = state.X.shape[0]
    cache = model.train_chol()
    cells = make_in_graph_nehvi_cells(model, cache, state.X, base[:, :cap], ref_point,
                                      baseline_mask=torch.arange(cap) < state.n)
    return _qlognehvi(model, cache, state, base, ref_point, cells, 1 + j, pending if j else None)


def phase_mo_step():
    """One config-4 step at the padded state after the initial design (10
    BraninCurrin points of seed 0 in 90 rows), on the card and on the CPU
    (plain versions), from the same fit starts, initial conditions of each
    of the 4 picks, and base samples. A pick that differs by more than
    `MO_STEP_TOL` passes if the CPU's acquisition of that pick (its fitted
    model, the card's earlier picks pending) is at the card's candidate
    within `MO_PICK_ACQ_TOL` of its value at the CPU's."""
    import torch

    from botorch_tpu_torch.acquisition.monte_carlo import draw_fresh_base_samples
    from botorch_tpu_torch.fit import _prepare_fit
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.mo_loop import (
        MOBOState, _mo_bo_step, append_mo_observations, init_mo_state,
    )
    from botorch_tpu_torch.sampling.sobol import sobol_table
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin

    prob = BraninCurrin(negate=True)
    d, q = CONFIG4["d"], CONFIG4["q"]
    cap = CONFIG4["n_init"] + CONFIG4["iterations"] * q
    state, X0 = init_mo_state(CONFIG4["n_init"], d, CONFIG4["m"], cap, seed=0, device="cpu")
    state = append_mo_observations(state, X0, prob(X0))
    mask = torch.arange(cap) < state.n
    model = make_gp(state.X, state.Y, mask=mask, device="cpu")
    _, _, x0, _, _ = _prepare_fit(model, make_generator(1, "cpu"), MO_CFG["fit_restarts"])
    ics = torch.rand(q, MO_CFG["num_restarts"], 1, d, generator=make_generator(2, "cpu"))
    base = draw_fresh_base_samples(cap + q, CONFIG4["m"], MO_CFG["mc_samples"],
                                   make_generator(3, "cpu"), seed=23)
    out = {}
    for dev in ("cpu", "cuda"):
        st = MOBOState(X=state.X.to(dev), Y=state.Y.to(dev), n=state.n)
        t0 = time.perf_counter()
        cand, val, params = _mo_bo_step(
            st, sobol_table(q * d, seed=0, device=dev), make_generator(0, dev),
            prob.ref_point, q=q, fit_x0=x0, initial_conditions=ics, base_samples=base, **MO_CFG)
        out[dev] = {"candidate": cand.cpu(), "value": float(val), "params": params,
                    "seconds": time.perf_counter() - t0}
    c_gpu, c_cpu = out["cuda"]["candidate"], out["cpu"]["candidate"]
    pick_err = [max_err(c_gpu[j], c_cpu[j]) for j in range(q)]
    val_err = abs(out["cuda"]["value"] - out["cpu"]["value"]) / max(1.0, abs(out["cpu"]["value"]))
    fitted = make_gp(state.X, state.Y, mask=mask, device="cpu").replace(
        params=out["cpu"]["params"])
    ref = prob.ref_point
    picks, ok = [], bool(((c_gpu >= 0) & (c_gpu <= 1)).all())
    for j in range(q):
        row = {"pick": j, "candidate_max_abs_err": pick_err[j]}
        if not (math.isfinite(pick_err[j]) and pick_err[j] <= MO_STEP_TOL):
            acqf = _pick_acqf(fitted, state, base, ref, j, c_gpu[:j])
            with torch.no_grad():
                at_card = float(acqf(c_gpu[j:j + 1][None]))
                at_cpu = float(acqf(c_cpu[j:j + 1][None]))
            row.update(acq_at_card=at_card, acq_at_cpu=at_cpu)
            ok &= math.isfinite(at_card) and at_card >= at_cpu - MO_PICK_ACQ_TOL * max(
                1.0, abs(at_cpu))
        picks.append(row)
    # the value of the last pick moves with its candidate; held where every
    # pick agrees
    if all(e <= MO_STEP_TOL for e in pick_err):
        ok &= val_err <= MO_STEP_TOL
    return {"phase": "mo_step", "ok": bool(ok), "picks": picks, "value_rel_err": val_err,
            "tol": MO_STEP_TOL, "pick_acq_tol": MO_PICK_ACQ_TOL,
            "value": {k: v["value"] for k, v in out.items()},
            "seconds": {k: v["seconds"] for k, v in out.items()},
            "raw_lengthscale_max_abs_err": max_err(out["cuda"]["params"].raw_lengthscale.cpu(),
                                                   out["cpu"]["params"].raw_lengthscale)}


def phase_mo_loop():
    """Config 4 through `run_mo_bo_loop` at `bench.py`'s budgets, seed 0,
    all 20 iterations, with K1's and K2's launches over the run (K2's by
    shape and path), the observed hypervolume's fraction of `max_hv`
    beside the initial design's, and one profiled step at the last history
    size."""
    import torch

    from botorch_tpu_torch.mo_loop import (
        MOBOState, _mo_bo_step, observed_hypervolume, run_mo_bo_loop,
    )
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.sampling.sobol import sobol_table
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin

    prob = BraninCurrin(negate=True)
    n0, iters, q, d = CONFIG4["n_init"], CONFIG4["iterations"], CONFIG4["q"], CONFIG4["d"]
    cap = n0 + iters * q
    loop = dict(d=d, m=CONFIG4["m"], ref_point=prob.ref_point, n_init=n0, q=q, **MO_CFG)
    # warm-up at the same capacity, then the counted, timed run
    run_mo_bo_loop(prob, iterations=1, capacity=cap, seed=1, **loop)
    torch.cuda.synchronize()
    _reset_counts()
    run = {}
    t0 = time.perf_counter()
    k2_shapes = k2_shapes_of(lambda: run.update(
        state=run_mo_bo_loop(prob, iterations=iters, seed=0, **loop)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state = run["state"]
    launches = {"mvn_quad_logdet": qd_cuda.launches, "kernel_matrix": kernel_matrix_cuda.launches}
    by_path = {}
    for row in k2_shapes:
        by_path[row["path"]] = by_path.get(row["path"], 0) + row["launches"]
    hv = observed_hypervolume(state, prob.ref_point)
    hv0 = observed_hypervolume(MOBOState(X=state.X, Y=state.Y, n=n0), prob.ref_point)
    X = state.X[: state.n]
    shape_ok = state.X.shape == (cap, d) and state.n == cap and state.X.is_cuda
    finite = bool(torch.isfinite(state.Y[: state.n]).all() and torch.isfinite(X).all())
    in_box = bool(((X >= 0) & (X <= 1)).all())
    frac, frac0 = hv / prob.max_hv, hv0 / prob.max_hv
    ok = (shape_ok and finite and in_box and frac >= HV_FRACTION_BAR and frac > frac0
          and launches["kernel_matrix"] > 0 and launches["mvn_quad_logdet"] == 0)
    last = MOBOState(X=state.X, Y=state.Y, n=state.n - q)
    sob = sobol_table(q * d, seed=0, device="cuda")
    return {
        "phase": "mo_loop", "ok": bool(ok), "wall_s": wall, "iterations": iters,
        "capacity": cap, "iters_per_s": iters / wall, "evals_per_s": iters * q / wall,
        "hypervolume": hv, "hv_fraction": frac, "initial_design_hv_fraction": frac0,
        "hv_fraction_bar": HV_FRACTION_BAR, "launches": launches,
        "kernel_matrix_by_path": by_path, "kernel_matrix_shapes": k2_shapes,
        "shape_ok": shape_ok, "finite": finite, "in_box": in_box,
        "last_step": profile_step(lambda: _mo_bo_step(
            last, sob, make_generator(5, "cuda"), prob.ref_point, q=q, **MO_CFG)),
    }


# ---------------------------------------------------------------------- #
def _svgp_bench_data():
    """`bench.py:294-331`'s SVGP data (config 5): 16384 uniform points in
    d = 20, `Y = -sum((X - 0.4)^2) + 0.01 eps`, from numpy seed 0, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    n, d = CONFIG5["svgp_n"], CONFIG5["d"]
    X = rng.uniform(size=(n, d)).astype(np.float32)
    Y = (-np.sum((X - 0.4) ** 2, axis=-1) + 0.01 * rng.normal(size=n)).astype(np.float32)
    return torch.tensor(X, device="cuda"), torch.tensor(Y, device="cuda")


def _exact_bench_model():
    """`bench.py:272-292`'s exact GP (config 5): 2048 uniform points in
    d = 20 and standard-normal Y from numpy seed 0, `make_gp` unfitted
    (rbf), on the card."""
    import numpy as np

    from botorch_tpu_torch.models.gp import make_gp

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(CONFIG5["exact_n"], CONFIG5["d"])).astype(np.float32)
    Y = rng.normal(size=CONFIG5["exact_n"]).astype(np.float32)
    return make_gp(X, Y[:, None])


def _turbo_draws(model, n_candidates: int, q: int, num_features: int, seed: int):
    """One TuRBO step's draws, made on the CPU in float64 and cast to the
    model's dtype, so the card and the CPU see the same numbers."""
    import torch

    from botorch_tpu_torch.models.approximate_gp import SVGP
    from botorch_tpu_torch.optim.turbo import TurboDraws
    from botorch_tpu_torch.sampling.pathwise import PathDraws, draw_path_draws

    g = torch.Generator().manual_seed(seed)
    d = model.X.shape[-1]
    k = model.num_inducing if isinstance(model, SVGP) else model.num_train
    kw = dict(generator=g, dtype=torch.float64)
    u, mask_u = torch.rand(n_candidates, d, **kw), torch.rand(n_candidates, d, **kw)
    forced = torch.randint(0, d, (n_candidates,), generator=g)
    ts = draw_path_draws(g, model.kernel, d, q, num_features, k, torch.float64)
    cast = lambda t: None if t is None else t.to(model.X.dtype)  # noqa: E731
    return TurboDraws(cast(u), cast(mask_u), forced, PathDraws(*(cast(t) for t in ts)))


def _on(draws, device):
    """`TurboDraws` with every tensor moved to `device`."""
    from botorch_tpu_torch.optim.turbo import TurboDraws
    from botorch_tpu_torch.sampling.pathwise import PathDraws

    ts = PathDraws(*(None if t is None else t.to(device) for t in draws.ts))
    return TurboDraws(draws.u.to(device), draws.mask_u.to(device), draws.forced.to(device), ts)


def turbo_step_case(model_cuda, model_cpu, center, n_candidates, q, num_features):
    """One `generate_turbo_candidates` on the card and on the CPU with the
    same draws: the perturbation set, the paths' values on it and the picks,
    each side's largest difference from the other."""
    import torch

    from botorch_tpu_torch.optim.turbo import (
        generate_turbo_candidates, turbo_candidate_set, turbo_init,
    )
    from botorch_tpu_torch.sampling.pathwise import draw_matheron_paths

    draws = _turbo_draws(model_cpu, n_candidates, q, num_features, seed=11)
    out = {}
    for dev, model in (("cuda", model_cuda), ("cpu", model_cpu)):
        st = turbo_init(best_value=0.0, device=dev)
        dr = _on(draws, dev)
        c = center.to(dev)
        Xc = turbo_candidate_set(model, st, c, n_candidates=n_candidates, draws=dr)
        vals = draw_matheron_paths(model, num_paths=q, num_features=num_features, draws=dr.ts)(Xc)
        cand = generate_turbo_candidates(model, st, c, n_candidates=n_candidates, q=q,
                                         num_features=num_features, draws=dr)
        out[dev] = (Xc.cpu(), vals.cpu(), cand.cpu())
    (Xg, vg, cg), (Xh, vh, ch) = out["cuda"], out["cpu"]
    scale = max(1.0, float(vh.abs().max()))
    value_err = max_err(vg, vh) / scale
    top = vh.double().sort(-1).values
    # a draw whose CPU margin exceeds twice the value tolerance has one argmax
    clear = (top[:, -1] - top[:, -2]) > 2 * TURBO_STEP_TOL * scale
    # the same row of the perturbation set, which each side rounds in its
    # own order (`lb + (ub - lb) u`): within one float32 ulp
    same = (cg - ch).abs().amax(-1) <= 1e-6
    ok = (max_err(Xg, Xh) <= 1e-6 and value_err <= TURBO_STEP_TOL
          and bool(same[clear].all()) and bool(torch.isfinite(vg).all()))
    return {"ok": bool(ok), "n_candidates": n_candidates, "q": q, "num_features": num_features,
            "candidate_set_max_abs_err": max_err(Xg, Xh), "value_rel_err": value_err,
            "value_tol": TURBO_STEP_TOL, "value_abs_max": scale,
            "picks_same": int(same.sum()), "picks_clear": int(clear.sum()),
            "pick_max_abs_err": max_err(cg, ch),
            "values_head": vg[0, :4].tolist(), "picks_head": cg[0].tolist()}


def phase_turbo_step():
    """One config-5 TuRBO step on the card against the same step on the
    CPU, from the same draws: for `bench.py`'s exact GP (n = 2048, d = 20,
    rbf, 4096 candidates, q = 64, 512 features) and for an SVGP of its
    16384 points (256 inducing points, 30 Adam steps on the card, carried
    to the CPU; 2048 candidates, q = 64, 512 features)."""
    import torch

    from botorch_tpu_torch.fit import _to_device
    from botorch_tpu_torch.models.approximate_gp import fit_svgp, make_svgp
    from botorch_tpu_torch.settings import make_generator

    exact = _exact_bench_model()
    X6, Y6 = _svgp_bench_data()
    svgp = fit_svgp(make_svgp(X6, Y6, num_inducing=CONFIG5["inducing"]),
                    make_generator(0, "cuda"), steps=30, batch_size=CONFIG5["batch"])
    cases = {
        "exact": turbo_step_case(exact, _to_device(exact, torch.device("cpu")), exact.X[0].cpu(),
                                 CONFIG5["exact_candidates"], CONFIG5["q"], 512),
        "svgp": turbo_step_case(svgp, svgp.to("cpu"), X6[int(Y6.argmax())].cpu(),
                                CONFIG5["svgp_candidates"], CONFIG5["q"], 512),
    }
    return {"phase": "turbo_step", "ok": all(c["ok"] for c in cases.values()), **cases}


def _timed(fn, reps: int) -> tuple[float, bool]:
    """Seconds per call of `fn(seed)` over `reps` calls after one warm
    call, ended by a synchronize, and whether every call's output was
    finite."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    finite = True
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn(1 + i)
        finite &= bool(torch.isfinite(out).all())
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, finite


def phase_turbo_exact():
    """Config 5's exact-GP half: `bench.py:272-292`'s Thompson-sampling
    throughput (10 calls of `generate_turbo_candidates` on its unfitted
    n = 2048, d = 20 rbf GP: 4096 candidates, q = 64, 512 features), then
    `run_turbo(model_type="exact")` on negated Ackley-4 at the reference
    test's budget (n_init 10, 15 iterations, q = 2, 256 candidates,
    fit_maxiter 25, capacity 40), seed 0: the best value beside the initial
    design's, K1's launches by shape (the MAP fit's (2, 40)) and K2's by
    shape and path."""
    import torch

    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.optim.turbo import generate_turbo_candidates, run_turbo, turbo_init
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.synthetic import Ackley
    from botorch_tpu_torch.utils.transforms import unnormalize

    model = _exact_bench_model()
    st = turbo_init(best_value=model.Y_loc[0] + model.Y_scale[0] * model.Y.max())
    q, reps = CONFIG5["q"], CONFIG5["gen_calls"]

    def gen(seed):
        return generate_turbo_candidates(model, st, model.X[0], make_generator(seed, "cuda"),
                                         n_candidates=CONFIG5["exact_candidates"], q=q,
                                         num_features=512)

    _reset_counts()
    run = {}
    run["bench_shapes"] = k2_shapes_of(lambda: run.update(s=_timed(gen, reps)))
    gen_s, gen_finite = run["s"]
    prob = Ackley(dim=4, negate=True)
    bounds = prob.bounds.cuda()

    def objective(X):
        return prob(unnormalize(X, bounds))

    cfg = TURBO_EXACT_CFG
    run_turbo(objective, seed=1, **dict(cfg, iterations=1))  # warm-up
    torch.cuda.synchronize()
    qd_cuda.launches = kernel_matrix_cuda.launches = 0
    t0 = time.perf_counter()
    k1_shapes = k1_shapes_of(lambda: run.update(
        k2=k2_shapes_of(lambda: run.update(xy=run_turbo(objective, seed=0, **cfg)))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    X, Y = run["xy"]
    n0, cap = cfg["n_init"], cfg["n_init"] + cfg["iterations"] * cfg["q"]
    best, best0 = float(Y.max()), float(Y[:n0].max())
    main_k1 = sum(r["launches"] for r in k1_shapes if (r["B"], r["n"]) == (2, cap))
    finite = bool(torch.isfinite(Y).all() and torch.isfinite(X).all())
    in_box = bool(((X >= 0) & (X <= 1)).all())
    ok = (finite and gen_finite and in_box and X.is_cuda and X.shape == (cap, 4)
          and best > best0 and main_k1 > 0 and kernel_matrix_cuda.launches > 0)
    return {
        "phase": "turbo_exact", "ok": bool(ok),
        "gen_calls": reps, "gen_ms": 1e3 * gen_s, "candidates_per_s": q / gen_s,
        "gen_kernel_matrix_shapes": run["bench_shapes"],
        "loop_wall_s": wall, "iterations": cfg["iterations"], "capacity": cap,
        "iters_per_s": cfg["iterations"] / wall, "best_value": best,
        "initial_design_best": best0, "optimum": prob.optimal_value,
        "launches": {"mvn_quad_logdet": qd_cuda.launches,
                     "kernel_matrix": kernel_matrix_cuda.launches},
        "mvn_quad_logdet_shapes": k1_shapes, "kernel_matrix_shapes": run["k2"],
        "finite": finite, "in_box": in_box,
    }


def adam_step_launches(model, batch: int) -> dict:
    """Device launches of one SVGP loss evaluation without gradient and of
    one whole Adam step (loss, backward through K2's plain version, update)."""
    import torch

    from botorch_tpu_torch.models.approximate_gp import fit_svgp

    idx = torch.randint(0, model.Y.shape[0], (1, batch), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))

    def loss():
        with torch.no_grad():
            return model.elbo(idx[0]) + model.log_prior()

    def step():
        return fit_svgp(model, steps=1, batch_size=batch, batch_indices=idx)

    step()  # warm-up: a profile can miss the first launches of a new call
    return {name: sum(c for c, _ in device_profile(fn).values())
            for name, fn in (("loss", loss), ("adam_step", step))}


def phase_turbo_svgp():
    """Config 5's SVGP half, seed 0: `bench.py:294-331`'s ELBO throughput
    (`make_svgp` with 256 inducing points by greedy variance reduction,
    then 300 Adam steps at batch 512, on its 16384-point data set) and
    Thompson-sampling throughput (10 calls of `generate_turbo_candidates`:
    2048 candidates, q = 64); then the closed loop `run_turbo(model_type=
    "svgp")` on -sum((x - 0.4)^2), d = 20, 16384 Sobol points, 4
    iterations of q = 64, 2048 candidates, 256 inducing points, 300 steps:
    the best value beside the initial design's, K2's launches by shape and
    path in the loop (`launches`, `kernel_matrix_shapes`) and in the
    benches (`bench_launches`, `bench_kernel_matrix_shapes`), each counted
    from 0, the launches of one Adam step, and one profiled iteration at
    the loop's last history size."""
    import torch

    from botorch_tpu_torch.models.approximate_gp import fit_svgp, make_svgp
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.optim.turbo import generate_turbo_candidates, run_turbo, turbo_init
    from botorch_tpu_torch.settings import make_generator

    X6, Y6 = _svgp_bench_data()
    m, steps, batch, q = (CONFIG5[k] for k in ("inducing", "svgp_steps", "batch", "q"))

    def fit(seed, steps=steps):
        return fit_svgp(make_svgp(X6, Y6, num_inducing=m), make_generator(seed, "cuda"),
                        steps=steps, batch_size=batch)

    fit(0, steps=5)  # warm-up
    torch.cuda.synchronize()
    run = {}

    def benches():
        t0 = time.perf_counter()
        run["svgp"] = fit(1)
        torch.cuda.synchronize()
        run["fit_s"] = time.perf_counter() - t0
        st = turbo_init(best_value=Y6.max())
        center = X6[int(Y6.argmax())]
        run["gen_s"], run["gen_finite"] = _timed(lambda seed: generate_turbo_candidates(
            run["svgp"], st, center, make_generator(seed, "cuda"),
            n_candidates=CONFIG5["svgp_candidates"], q=q), CONFIG5["gen_calls"])

    def objective(X):
        return -torch.sum((X - 0.4) ** 2, dim=-1)

    cfg = TURBO_SVGP_CFG

    def loop():
        t0 = time.perf_counter()
        run["xy"] = run_turbo(objective, seed=0, **cfg)
        torch.cuda.synchronize()
        run["loop_s"] = time.perf_counter() - t0

    # each path's launches alone: the counts go to 0 just before it
    _reset_counts()
    bench_shapes = k2_shapes_of(benches)
    bench_launches = {"mvn_quad_logdet": qd_cuda.launches,
                      "kernel_matrix": kernel_matrix_cuda.launches}
    _reset_counts()
    k2_shapes = k2_shapes_of(loop)
    X, Y = run["xy"]
    n0 = cfg["n_init"]
    best, best0 = float(Y.max()), float(Y[:n0].max())
    by_path = {}
    for row in k2_shapes:
        by_path[row["path"]] = by_path.get(row["path"], 0) + row["launches"]
    finite = bool(torch.isfinite(Y).all() and torch.isfinite(X).all())
    in_box = bool(((X >= 0) & (X <= 1)).all())
    svgp = run["svgp"]
    elbo = float(svgp.elbo() + svgp.log_prior())
    ok = (finite and run["gen_finite"] and in_box and X.is_cuda
          and X.shape == (n0 + cfg["iterations"] * q, CONFIG5["d"])
          and best > best0 and kernel_matrix_cuda.launches > 0 and qd_cuda.launches == 0
          and bench_launches["kernel_matrix"] > 0 and bench_launches["mvn_quad_logdet"] == 0
          and math.isfinite(elbo))
    n_last = n0 + (cfg["iterations"] - 1) * q
    st_last = turbo_init(best_value=Y[:n_last].max())
    center = X[int(Y[:n_last].argmax())]

    def step():
        model = fit_svgp(make_svgp(X[:n_last], Y[:n_last], num_inducing=m),
                         make_generator(5, "cuda"), steps=steps, batch_size=batch)
        return generate_turbo_candidates(model, st_last, center, make_generator(6, "cuda"),
                                         n_candidates=cfg["n_candidates"], q=q,
                                         lengthscale_override=model.lengthscale)

    return {
        "phase": "turbo_svgp", "ok": bool(ok),
        "fit_s": run["fit_s"], "elbo_steps": steps, "elbo_steps_per_s": steps / run["fit_s"],
        "elbo_plus_log_prior": elbo, "gen_calls": CONFIG5["gen_calls"],
        "gen_ms": 1e3 * run["gen_s"], "candidates_per_s": q / run["gen_s"],
        "loop_wall_s": run["loop_s"], "iterations": cfg["iterations"],
        "iters_per_s": cfg["iterations"] / run["loop_s"], "best_value": best,
        "initial_design_best": best0,
        "launches": {"mvn_quad_logdet": qd_cuda.launches,
                     "kernel_matrix": kernel_matrix_cuda.launches},
        "kernel_matrix_by_path": by_path, "kernel_matrix_shapes": k2_shapes,
        "bench_launches": bench_launches, "bench_kernel_matrix_shapes": bench_shapes,
        "adam_step_launches": adam_step_launches(svgp, batch),
        "finite": finite, "in_box": in_box, "last_step": profile_step(step),
    }


# ---------------------------------------------------------------------- #
# Constrained acquisition optimization (ROADMAP item 17)


def _unit_bounds(d: int, device, dtype=None):
    import torch

    dtype = dtype or torch.float32
    return torch.stack([torch.zeros(d, dtype=dtype, device=device),
                        torch.ones(d, dtype=dtype, device=device)])


def gramacy_evaluate(X):
    """`(n, 3)` observations of negated ConstrainedGramacy at `X (n, 2)`: the
    objective to maximize, then its two slacks (feasible where both >= 0)."""
    import torch

    from botorch_tpu_torch.test_functions.extra import ConstrainedGramacy

    prob = ConstrainedGramacy(negate=True)
    return torch.cat([prob(X)[:, None], prob.evaluate_slack(X)], dim=-1)


def gramacy_step(X, Y, n: int, sobol, generator, params0=None, fit_x0=None,
                 initial_conditions=None, cfg=LOOP_CFG):
    """One constrained-Gramacy iteration on the padded history `X (cap, 2)`,
    `Y (cap, 3)` with `n` valid rows: a 3-output GP fit, then
    `LogConstrainedExpectedImprovement` (slacks >= 0, `best_f` the best
    feasible objective, or the lowest one while none is feasible) maximized
    in the unit square, its raw points continuing the `sobol` stream.
    Returns `(candidate (1, 2), value, fitted GPParams)`."""
    import torch

    from botorch_tpu_torch.acquisition.analytic import LogConstrainedExpectedImprovement
    from botorch_tpu_torch.fit import fit_gp
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.optim.optimize import optimize_acqf

    device = X.device
    mask = torch.arange(X.shape[0], device=device) < n
    model = make_gp(X, Y, mask=mask, device=device)
    if params0 is not None:
        model = model.replace(params=params0)
    model = fit_gp(model, generator, num_restarts=cfg["fit_restarts"], maxiter=cfg["fit_maxiter"],
                   x0=fit_x0, device=device)
    feasible = mask & torch.all(Y[:, 1:] >= 0, dim=-1)
    best_f = torch.amax(torch.where(feasible, Y[:, 0], -torch.inf))
    best_f = torch.where(torch.isfinite(best_f), best_f,
                         torch.amin(torch.where(mask, Y[:, 0], torch.inf)))
    acqf = LogConstrainedExpectedImprovement(
        model=model, cache=model.train_chol(), best_f=best_f,
        constraint_lower=torch.tensor(GRAMACY_LOWER, device=device),
        constraint_upper=torch.full((3,), torch.inf, device=device),
    )
    cand, val = optimize_acqf(
        acqf, _unit_bounds(2, device), q=1, num_restarts=cfg["num_restarts"],
        raw_samples=cfg["raw_samples"], generator=generator, maxiter=cfg["acq_maxiter"],
        initial_conditions=initial_conditions, sobol=sobol,
        sobol_skip=((n + 1) * cfg["raw_samples"]) & 0xFFFFFFFF, device=device,
    )
    return cand, val, model.params


def hartmann_linear_step(X, Y, n: int, generator, params0=None, fit_x0=None,
                         initial_conditions=None, cfg=LOOP_CFG):
    """One Hartmann-6 iteration under `sum(x) <= 3` on the padded history
    `X (cap, 6)`, `Y (cap,)` with `n` valid rows: the GP fit, then LogEI
    maximized by `optimize_acqf(inequality_constraints=...)` (polytope
    initial conditions, the augmented Lagrangian, the Dykstra polish).
    Returns `(candidate (1, 6), value, fitted GPParams)`."""
    import torch

    from botorch_tpu_torch.acquisition.analytic import LogExpectedImprovement
    from botorch_tpu_torch.fit import fit_gp
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.optim.optimize import optimize_acqf

    device = X.device
    mask = torch.arange(X.shape[0], device=device) < n
    model = make_gp(X, Y[:, None], mask=mask, device=device)
    if params0 is not None:
        model = model.replace(params=params0)
    model = fit_gp(model, generator, num_restarts=cfg["fit_restarts"], maxiter=cfg["fit_maxiter"],
                   x0=fit_x0, device=device)
    acqf = LogExpectedImprovement(model=model, cache=model.train_chol(),
                                  best_f=torch.amax(torch.where(mask, Y, -torch.inf)))
    cand, val = optimize_acqf(
        acqf, _unit_bounds(6, device), q=1, num_restarts=cfg["num_restarts"],
        raw_samples=cfg["raw_samples"], generator=generator, maxiter=cfg["acq_maxiter"],
        initial_conditions=initial_conditions, inequality_constraints=HARTMANN_SUM_LE_3,
        device=device,
    )
    return cand, val, model.params


def gramacy_loop(seed: int = 0, n_init: int = 10, iterations: int = 20, device="cuda",
                 cfg=LOOP_CFG):
    """The closed ConstrainedGramacy loop: `n_init` scrambled Sobol points,
    then `iterations` of `gramacy_step`, each fit warm-started from the
    last. Returns the history `(X (n, 2), Y (n, 3))`."""
    import torch

    from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table
    from botorch_tpu_torch.settings import make_generator

    cap = n_init + iterations
    sobol = sobol_table(2, scramble=True, seed=seed, device=device)
    X = torch.zeros((cap, 2), device=device)
    Y = torch.zeros((cap, 3), device=device)
    X[:n_init] = draw_sobol(*sobol, n_init)
    Y[:n_init] = gramacy_evaluate(X[:n_init])
    generator = make_generator(seed, device)
    params = None
    for i in range(iterations):
        n = n_init + i
        cand, _, params = gramacy_step(X, Y, n, sobol, generator, params0=params, cfg=cfg)
        X[n] = cand[0]
        Y[n] = gramacy_evaluate(cand)[0]
    return X, Y


def hartmann_linear_loop(seed: int = 0, n_init: int = 10, iterations: int = 12, device="cuda",
                         cfg=LOOP_CFG):
    """The closed Hartmann-6 loop under `sum(x) <= 3`: `n_init` points from
    `get_polytope_samples`, then `iterations` of `hartmann_linear_step`.
    Returns the history `(X (n, 6), Y (n,))` (Y negated Hartmann)."""
    import torch

    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.synthetic import Hartmann
    from botorch_tpu_torch.utils.sampling import get_polytope_samples

    prob = Hartmann(dim=6, negate=True)
    cap = n_init + iterations
    generator = make_generator(seed, device)
    X = torch.zeros((cap, 6), device=device)
    Y = torch.zeros((cap,), device=device)
    X[:n_init] = get_polytope_samples(generator, n_init, _unit_bounds(6, device),
                                      inequality_constraints=HARTMANN_SUM_LE_3)
    Y[:n_init] = prob(X[:n_init])
    params = None
    for i in range(iterations):
        n = n_init + i
        cand, _, params = hartmann_linear_step(X, Y, n, generator, params0=params, cfg=cfg)
        X[n] = cand[0]
        Y[n] = prob(cand)[0]
    return X, Y


def _fit_same_starts(X, Y, device):
    """A GP on `(X, Y)` fitted on `device` at config 1's fit budget from
    starts drawn once on the CPU, so card and CPU fit from the same ones."""
    from botorch_tpu_torch.fit import _prepare_fit, fit_gp
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.settings import make_generator

    x0 = _prepare_fit(make_gp(X, Y, device="cpu"), make_generator(1, "cpu"),
                      LOOP_CFG["fit_restarts"])[2]
    return fit_gp(make_gp(X, Y, device=device), num_restarts=LOOP_CFG["fit_restarts"],
                  maxiter=LOOP_CFG["fit_maxiter"], x0=x0.to(device), device=device)


CONSTRAINED_CASES = ("outcome_qlogei", "simplex_logei", "interpoint_budget", "nonlinear_ball")


def constrained_case(name: str, device):
    """`(acqf, q, d, constraint kwargs)` of one constrained branch on
    `device`: example 06's outcome-constrained qLogEI (a 2-output GP, n =
    15, d = 2, 128 MC samples) under `x0 + x1 >= 0.5`; example 12's LogEI
    (n = 20, d = 3) on the simplex `sum(x) = 1` with `x0 <= 0.5`; the
    inter-point budget `sum of both candidates' coordinates <= 1.2` at q = 2
    (`tests/test_constraints.py:162`); Hartmann-6 LogEI (n = 16) under the
    intra-point nonlinear `1 - |x|^2 >= 0` (ConstrainedHartmannSmooth's)."""
    import numpy as np
    import torch

    from botorch_tpu_torch.acquisition.analytic import LogExpectedImprovement
    from botorch_tpu_torch.acquisition.monte_carlo import make_mc_acqf, qLogExpectedImprovement
    from botorch_tpu_torch.test_functions.synthetic import Hartmann

    rng = np.random.default_rng(0)
    if name == "interpoint_budget":
        budget = [(((0, 0), (0, 1), (1, 0), (1, 1)), (-1.0,) * 4, -1.2)]
        return (lambda X: X.sum((-1, -2))), 2, 2, dict(inequality_constraints=budget)
    if name == "outcome_qlogei":
        X = rng.uniform(size=(15, 2)).astype(np.float32)
        Y = np.stack([np.sin(5 * X[:, 0]) + X[:, 1], X[:, 0] - 0.6], -1).astype(np.float32)
        model = _fit_same_starts(X, Y, device)
        acqf = make_mc_acqf(qLogExpectedImprovement, model, q=1, num_samples=128,
                            best_f=float(np.max(np.where(Y[:, 1] <= 0, Y[:, 0], -np.inf))),
                            constraints=(lambda s: s[..., 1],))
        return acqf, 1, 2, dict(inequality_constraints=[((0, 1), (1.0, 1.0), 0.5)])
    if name == "simplex_logei":
        X = rng.dirichlet(np.ones(3), size=20).astype(np.float32)
        Y = (np.sin(4 * X[:, 0]) + X[:, 1] - 0.5 * X[:, 2] + 0.05 * rng.normal(size=20))
        cons = dict(equality_constraints=[((0, 1, 2), (1.0, 1.0, 1.0), 1.0)],
                    inequality_constraints=[((0,), (-1.0,), -0.5)])
    else:
        X = (0.5 * rng.uniform(size=(16, 6))).astype(np.float32)
        Y = Hartmann(dim=6, negate=True)(torch.tensor(X)).numpy()
        cons = dict(nonlinear_inequality_constraints=[
            lambda x: 1.0 - torch.sum(torch.square(x), dim=-1)])
    model = _fit_same_starts(X, np.asarray(Y, np.float32)[:, None], device)
    acqf = LogExpectedImprovement(model=model, cache=model.train_chol(), best_f=float(Y.max()))
    return acqf, 1, X.shape[1], cons


def constrained_step_case(name: str) -> dict:
    """One constrained `optimize_acqf` on the card and on the CPU from the
    same fit starts and initial conditions: the candidates' distance, the
    values, both sides' violation (the card's at most `FEASIBILITY_TOL`);
    where the candidate moves beyond `CONSTRAINED_STEP_TOL`, the CPU
    acquisition at the card's candidate against its value at its own."""
    import numpy as np
    import torch

    from botorch_tpu_torch.optim.constraints import FEASIBILITY_TOL, max_violation
    from botorch_tpu_torch.optim.optimize import optimize_acqf

    out = {}
    for dev in ("cpu", "cuda"):
        acqf, q, d, cons = constrained_case(name, dev)
        ics = np.random.default_rng(5).uniform(size=(LOOP_CFG["num_restarts"], q, d))
        cand, val = optimize_acqf(acqf, _unit_bounds(d, dev), q=q, maxiter=LOOP_CFG["acq_maxiter"],
                                  initial_conditions=torch.tensor(ics, dtype=torch.float32),
                                  device=dev, **cons)
        out[dev] = (acqf, cand.cpu(), float(val))
    (acq_cpu, c_cpu, v_cpu), (_, c_gpu, v_gpu) = out["cpu"], out["cuda"]
    cand_err = max_err(c_gpu, c_cpu)
    value_err = abs(v_gpu - v_cpu) / max(1.0, abs(v_cpu))
    viol = {dev: float(max_violation(c, **cons).max())
            for dev, c in (("cuda", c_gpu), ("cpu", c_cpu))}
    case = {"name": name, "q": q, "d": d, "candidate_max_abs_err": cand_err,
            "value_cuda": v_gpu, "value_cpu": v_cpu, "value_rel_err": value_err,
            "violation": viol, "feasibility_tol": FEASIBILITY_TOL}
    close = cand_err <= CONSTRAINED_STEP_TOL and value_err <= CONSTRAINED_STEP_TOL
    if not close:
        with torch.no_grad():
            at_card = float(acq_cpu(c_gpu[None]))
        case["cpu_acq_at_card_candidate"] = at_card
        close = at_card >= v_cpu - CONSTRAINED_STEP_TOL * max(1.0, abs(v_cpu))
    case["ok"] = bool(close and viol["cuda"] <= FEASIBILITY_TOL and viol["cpu"] <= FEASIBILITY_TOL
                      and math.isfinite(v_gpu))
    return case


def host_syncs(fn) -> int:
    """Synchronizing CUDA operations in one call of `fn`: the host reads
    (`bool()` of a device tensor, `.item()`) and blocking copies, counted by
    PyTorch's sync debug mode."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def call_cost(fn) -> dict:
    """Device launches, busy ms and host syncs of one call of `fn`, and its
    wall ms, all from that one call, profiled with the sync debug mode on
    (the wall includes what the profiler and the sync checks cost)."""
    import torch

    syncs, wall = [], []

    def timed():
        t0 = time.perf_counter()
        syncs.append(host_syncs(fn))
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))

    torch.cuda.synchronize()
    rows = device_profile(timed, cpu=False)
    return {"profiled_wall_ms": wall[0], "device_launches": sum(c for c, _ in rows.values()),
            "device_busy_ms": sum(us for _, us in rows.values()) / 1e3, "host_syncs": syncs[0]}


def phase_constrained_step():
    """The four constrained branches card against CPU, then on the card one
    whole `optimize_acqf` call of each (its own initial conditions, config
    1's 6 restarts and 64 raw samples), profiled: device launches, host
    syncs, wall ms; and the hit-and-run chain of the polytope branch alone
    (64 points in d = 6, 200 + 64 * 32 steps), its wall ms from a second,
    unprofiled call."""
    import torch

    from botorch_tpu_torch.optim.optimize import optimize_acqf
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.utils.sampling import get_polytope_samples

    cases = [constrained_step_case(name) for name in CONSTRAINED_CASES]
    calls = {}
    for name in CONSTRAINED_CASES:
        acqf, q, d, cons = constrained_case(name, "cuda")
        gen = make_generator(3, "cuda")
        calls[name] = call_cost(lambda: optimize_acqf(
            acqf, _unit_bounds(d, "cuda"), q=q, num_restarts=LOOP_CFG["num_restarts"],
            raw_samples=LOOP_CFG["raw_samples"], generator=gen, maxiter=LOOP_CFG["acq_maxiter"],
            device="cuda", **cons))
    gen = make_generator(4, "cuda")
    n_pts = LOOP_CFG["raw_samples"]

    def chain_call():
        get_polytope_samples(gen, n_pts, _unit_bounds(6, "cuda"),
                             inequality_constraints=HARTMANN_SUM_LE_3)

    chain = call_cost(chain_call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain_call()
    torch.cuda.synchronize()
    chain["wall_ms"] = 1e3 * (time.perf_counter() - t0)
    chain["steps"] = 200 + 32 * n_pts
    chain["us_per_step"] = 1e3 * chain["wall_ms"] / chain["steps"]
    chain["launches_per_step"] = chain["device_launches"] / chain["steps"]
    torch.cuda.synchronize()
    return {"phase": "constrained_step", "ok": all(c["ok"] for c in cases), "cases": cases,
            "optimize_acqf_calls": calls, "hit_and_run": chain}


def phase_constrained_loop():
    """The ConstrainedGramacy loop (LogCEI, box-only `optimize_acqf`) and
    the Hartmann-6 loop under sum(x) <= 3 (polytope design, LogEI,
    `optimize_acqf(inequality_constraints=...)`), seed 0, config 1's
    budgets, each with K1's and K2's launches by shape: the Gramacy loop's
    best feasible value beside its design's and -0.5998, its feasible
    count; every Hartmann point feasible to `FEASIBILITY_TOL`, its regret."""
    import torch

    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.optim.constraints import FEASIBILITY_TOL

    def counted(run):
        box = {}
        qd_cuda.launches = 0
        kernel_matrix_cuda.launches = 0
        k2 = []
        t0 = time.perf_counter()
        k1 = k1_shapes_of(lambda: k2.extend(k2_shapes_of(lambda: box.update(out=run()))))
        torch.cuda.synchronize()
        return box["out"], {
            "wall_s": time.perf_counter() - t0,
            "launches": {"mvn_quad_logdet": qd_cuda.launches,
                         "kernel_matrix": kernel_matrix_cuda.launches},
            "mvn_quad_logdet_shapes": k1, "kernel_matrix_shapes": k2,
        }

    (X, Y), g = counted(lambda: gramacy_loop(seed=0, device="cuda", **GRAMACY_LOOP))
    X, Y = X.cpu(), Y.cpu()
    n0 = GRAMACY_LOOP["n_init"]
    feasible = torch.all(Y[:, 1:] >= 0, dim=-1)
    best = float(torch.where(feasible, Y[:, 0], -torch.inf).max())
    best0 = float(torch.where(feasible[:n0], Y[:n0, 0], -torch.inf).max())
    g.update(iterations=GRAMACY_LOOP["iterations"],
             iters_per_s=GRAMACY_LOOP["iterations"] / g["wall_s"], best_feasible=best,
             initial_design_best_feasible=best0, optimum=-GRAMACY_OPT, gap=-GRAMACY_OPT - best,
             feasible_evaluations=int(feasible.sum()), evaluations=len(Y),
             finite=bool(torch.isfinite(Y).all() and torch.isfinite(X).all()),
             in_box=bool(((X >= 0) & (X <= 1)).all()))
    g_ok = (g["finite"] and g["in_box"] and best > best0
            and all(v > 0 for v in g["launches"].values()))

    (X, Y), h = counted(lambda: hartmann_linear_loop(seed=0, device="cuda", **HARTMANN_LOOP))
    X, Y = X.cpu(), Y.cpu()
    n0 = HARTMANN_LOOP["n_init"]
    viol = torch.clamp(X.sum(-1) - 3.0, min=0.0)
    viol = torch.maximum(viol, torch.clamp(-X, min=0.0).amax(-1))
    viol = torch.maximum(viol, torch.clamp(X - 1.0, min=0.0).amax(-1))
    h.update(iterations=HARTMANN_LOOP["iterations"],
             iters_per_s=HARTMANN_LOOP["iterations"] / h["wall_s"],
             regret=HARTMANN6_OPT - float(Y.max()),
             initial_design_regret=HARTMANN6_OPT - float(Y[:n0].max()),
             max_violation=float(viol.max()), max_sum=float(X.sum(-1).max()),
             finite=bool(torch.isfinite(Y).all() and torch.isfinite(X).all()))
    h_ok = (h["finite"] and h["max_violation"] <= FEASIBILITY_TOL
            and all(v > 0 for v in h["launches"].values()))
    return {"phase": "constrained_loop", "ok": bool(g_ok and h_ok), "gramacy": g,
            "hartmann_sum_le_3": h}


def k1_shapes_of(step) -> list:
    """K1 launches of one call of `step` by (B, n), counted by wrapping the
    wrapper that `_qd_core` calls; its own count is carried back to it."""
    from collections import Counter

    from botorch_tpu_torch.ops import mvn_linalg

    inner = mvn_linalg.qd_cuda
    seen = Counter()

    def counting(K, r):
        seen[tuple(r.shape)] += 1
        return inner(K, r)

    counting.launches = 0  # the wrapper counts its launches on the name it is called by
    mvn_linalg.qd_cuda = counting
    try:
        step()
    finally:
        mvn_linalg.qd_cuda = inner
        inner.launches += counting.launches
    return [{"B": B, "n": n, "launches": c} for (B, n), c in seen.most_common()]


def step_breakdown(state, q: int, cfg: dict) -> dict:
    """Wall time of one BO step at the loop's last history size (the full
    state less one q-batch) and where its device time goes (profiled in a
    second, identical call)."""
    from botorch_tpu_torch.loop import BOState, _bo_step
    from botorch_tpu_torch.sampling.sobol import sobol_table
    from botorch_tpu_torch.settings import make_generator

    st = BOState(X=state.X, Y=state.Y, n=state.n - q)
    sob = sobol_table(q * state.X.shape[-1], seed=0, device="cuda")
    return profile_step(lambda: _bo_step(st, sob, make_generator(5, "cuda"), q=q, **cfg))


def profile_step(step) -> dict:
    """Wall time of a warm call of `step`, and where the device time of a
    second, identical call goes: launches and device ms of the kernels, K2
    by shape and path, the largest device kernels."""
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_profile(step)
    busy_ms = sum(us for _, us in rows.values()) / 1e3
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]

    def pick(tag):
        hits = [(c, us) for k, (c, us) in rows.items() if tag in k]
        return {"launches": sum(c for c, _ in hits), "device_ms": sum(us for _, us in hits) / 1e3}

    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches": sum(c for c, _ in rows.values()),
        "mvn_quad_logdet": pick("mvn_qd_kernel"), "kernel_matrix": pick("kernel_matrix_"),
        "gemm": pick("gemm"),
        "kernel_matrix_shapes": k2_shapes_of(step),
        "top_kernels": [{"name": k[:80], "launches": c, "device_ms": us / 1e3} for k, (c, us) in top],
    }


def k2_shapes_of(step) -> list:
    """K2 launches of one call of `step` by (B, n, m, d) and path, counted by
    wrapping the wrapper that `_KernelMatrix` calls for this one call. The
    wrapper's own count, which its launches add to the name it is called
    by, is carried back to it."""
    from collections import Counter

    import torch

    from botorch_tpu_torch.ops import kernel_matrix as km

    inner = km.kernel_matrix_cuda
    seen = Counter()
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def counting(x, z, lengthscale, kind):
        out = inner(x, z, lengthscale, kind)
        B = out.numel() // max(1, out.shape[-1] * out.shape[-2])
        n, m, d = out.shape[-2], out.shape[-1], x.shape[-1]
        seen[(B, n, m, d, km.k2_plan(B, n, m, d, x.dtype, num_sms)["path"])] += 1
        return out

    counting.launches = 0  # the wrapper counts its launches on the name it is called by
    km.kernel_matrix_cuda = counting
    try:
        step()
    finally:
        km.kernel_matrix_cuda = inner
        inner.launches += counting.launches
    return [{"B": B, "n": n, "m": m, "d": d, "path": path, "launches": c}
            for (B, n, m, d, path), c in seen.most_common()]


def kernels_line(k1, k2, loop, qnei, nuts, saasbo, mo, turbo_exact, turbo_svgp, gramacy):
    """One row per kernel at each main-path shape, its launches from the run
    of the loop that launches it there (`launches_from`): K1 at the
    config-1 fit's (B=2, n=35), config 3's NUTS potential in the saasbo
    loop's buffers (8, `SAASBO_LOOP_CAPACITY`) and the
    NUTS throughput shape (64, 24), float32; K2 at the config-1 fit's (B=2,
    35 x 35, d=2) and acquisition's (B=6, 35 x 1, d=2) and the config-2
    ascent's k(X_train, X_full) (B=6, 76 x 80, d=6), rbf float32, at the
    config-3 NUTS potential's (B=8, n x n, d=8) in the same buffers,
    matern52 float32, and at the config-4
    fit's (B=2, 90 x 90, d=2) and last pick's ascent k(X_train, X_full)
    (B=4, 90 x 94, d=2), rbf float32; config 5's: K1 at the exact TuRBO
    fit's (2, 40), K2 at the exact paths' (1, 4096 x 2048, 20) rbf and at
    the SVGP's Kzx (1, 256 x 512, 20), paths' Kxz (1, 2048 x 256, 20) and
    greedy column (1, 16384 x 1, 20), matern52, float32; and K1 at the
    ConstrainedGramacy loop's fit (2, 30) and K2 at its acquisition's
    (B=6, 30 x 1, d=2), float32, rbf.
    A row's `launches`
    counts the kernel's launches over that run at the row's shape where
    the run counts them by shape, else all of them. Every number but
    `bound_ms` is measured in this run."""
    def k1_at(B, n):
        c = next(c for c in k1["cases"] if (c["B"], c["n"], c["dtype"]) == (B, n, "float32"))
        return c, max(c["max_abs_err"].values())

    def k2_at(shape, kind):
        c = next(c for c in k2["cases"] if (c["B"], c["n"], c["m"], c["d"]) == shape
                 and (c["kind"], c["dtype"]) == (kind, "float32"))
        return c, c["max_abs_err"]

    def k1_launches(run, B, n):
        return next((r["launches"] for r in run["mvn_quad_logdet_shapes"]
                     if (r["B"], r["n"]) == (B, n)), 0)

    k1_src = ("mvn_quad_logdet", "botorch_tpu_torch/csrc/mvn_quad_logdet.cu",
              "botorch_tpu/ops/pallas_linalg.py:134")
    k2_src = ("kernel_matrix", "botorch_tpu_torch/csrc/kernel_matrix.cu",
              "botorch_tpu/ops/pallas_kernels.py:84")
    def k2_launches(shapes, shape):
        return sum(r["launches"] for r in shapes if (r["B"], r["n"], r["m"], r["d"]) == shape)

    n3 = SAASBO_LOOP_CAPACITY
    shape3 = (8, n3, n3, CONFIG3["d"])
    rows = [
        (*k1_src, (2, 35), *k1_at(2, 35), loop["launches"]["mvn_quad_logdet"], loop),
        (*k1_src, (8, n3), *k1_at(8, n3), k1_launches(saasbo, 8, n3), saasbo),
        (*k1_src, (64, 24), *k1_at(64, 24), nuts["launches"]["mvn_quad_logdet"], nuts),
    ]
    for shape, run in (((2, 35, 35, 2), loop), ((6, 35, 1, 2), loop), ((6, 76, 80, 6), qnei)):
        rows.append((*k2_src, shape, *k2_at(shape, "rbf"), run["launches"]["kernel_matrix"], run))
    rows.append((*k2_src, shape3, *k2_at(shape3, "matern52"),
                 k2_launches(saasbo["kernel_matrix_shapes"], shape3), saasbo))
    for shape in ((2, 90, 90, 2), (4, 90, 94, 2)):
        rows.append((*k2_src, shape, *k2_at(shape, "rbf"),
                     k2_launches(mo["kernel_matrix_shapes"], shape), mo))
    rows.append((*k1_src, (2, 40), *k1_at(2, 40), k1_launches(turbo_exact, 2, 40), turbo_exact))
    shape = (1, 4096, 2048, 20)
    rows.append((*k2_src, shape, *k2_at(shape, "rbf"),
                 k2_launches(turbo_exact["gen_kernel_matrix_shapes"], shape), turbo_exact))
    for shape in ((1, 256, 512, 20), (1, 2048, 256, 20), (1, 16384, 1, 20)):
        rows.append((*k2_src, shape, *k2_at(shape, "matern52"),
                     k2_launches(turbo_svgp["kernel_matrix_shapes"], shape), turbo_svgp))
    run = {"phase": "constrained_loop"}
    rows.append((*k1_src, (2, 30), *k1_at(2, 30), k1_launches(gramacy, 2, 30), run))
    shape = (6, 30, 1, 2)
    rows.append((*k2_src, shape, *k2_at(shape, "rbf"),
                 k2_launches(gramacy["kernel_matrix_shapes"], shape), run))
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "shape": list(shape),
         "dtype": "float32", "kind": c.get("kind"), "path": c.get("path"), "launches": launches,
         "launches_from": run["phase"], "max_abs_err": err,
         "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": c["library_ms"], "floor_ms": c["floor_ms"]}
        for name, src, rep, shape, c, err, launches, run in rows
    ]}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import botorch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: botorch_tpu_torch is not importable: {e}", file=sys.stderr)
        return 2

    gen = torch.Generator().manual_seed(0)
    results, failed = {}, []
    phases = (
        ("build", phase_build), ("k1", lambda: phase_k1(gen)),
        ("k2", lambda: phase_k2(gen)), ("bo_step", phase_bo_step),
        ("bo_loop", phase_bo_loop), ("mc_step", phase_mc_step), ("qnei_loop", phase_qnei_loop),
        ("nuts_step", phase_nuts_step), ("nuts", phase_nuts),
        ("saasbo_loop", phase_saasbo_loop), ("mo_step", phase_mo_step), ("mo_loop", phase_mo_loop),
        ("turbo_step", phase_turbo_step), ("turbo_exact", phase_turbo_exact),
        ("turbo_svgp", phase_turbo_svgp), ("constrained_step", phase_constrained_step),
        ("constrained_loop", phase_constrained_loop),
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:  # a phase that raises is a failed phase
            traceback.print_exc()
            res = {"phase": name, "ok": False, "error": traceback.format_exc(limit=3)}
        res.setdefault("ok", True)
        res["phase_s"] = time.perf_counter() - t0
        results[name] = res
        emit(res)
        if not res["ok"]:
            failed.append(name)
            if name == "build":
                break
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit(kernels_line(results["k1"], results["k2"], results["bo_loop"], results["qnei_loop"],
                      results["nuts"], results["saasbo_loop"], results["mo_loop"],
                      results["turbo_exact"], results["turbo_svgp"],
                      results["constrained_loop"]["gramacy"]))
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
