"""The PyTorch port stands alone: no file of `botorch_tpu_torch/`,
`chip_smoke.py` or `tools/` imports JAX, flax or the JAX package, every module imports
on a CPU-only machine, and the entry points default to CUDA without ever
falling back to the CPU."""

import ast
import importlib
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import botorch_tpu_torch
from _torch_threads import _one_torch_thread  # noqa: F401


ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "botorch_tpu")


def _port_sources():
    files = sorted((ROOT / "botorch_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((ROOT / "tools").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_tools_import_no_jax(path):
    """The on-card measurement scripts stand on the port alone too."""
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_sources()[:-1],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reads_no_file_of_the_reference(path):
    """No string the package computes with names the JAX package's tree
    (docstrings, which cite reference lines, are not computed with)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    bad = [
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docstrings
        and ("botorch_tpu/" in node.value or node.value == "botorch_tpu")
    ]
    assert not bad, f"{path} names the reference's files: {bad}"


def test_sources_exist():
    names = {p.relative_to(ROOT / "botorch_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    for mod in (
        "settings.py", "convert.py", "fit.py", "loop.py",
        "utils/safe_math.py", "utils/probability.py", "utils/transforms.py",
        "sampling/sobol.py", "test_functions/synthetic.py",
        "ops/kernels.py", "ops/kernel_matrix.py", "ops/chol.py",
        "ops/mvn_linalg.py", "ops/lbfgs.py", "models/priors.py",
        "models/gp.py", "posteriors/gaussian.py", "acquisition/analytic.py",
        "optim/optimize.py", "sampling/qmc.py", "sampling/samplers.py",
        "acquisition/monte_carlo.py", "sampling/nuts.py", "models/fully_bayesian.py",
        "posteriors/fully_bayesian.py", "saasbo.py", "utils/multi_objective.py",
        "test_functions/multi_objective.py", "acquisition/multi_objective.py", "mo_loop.py",
        "models/approximate_gp.py", "sampling/pathwise.py", "generation/sampling.py",
        "optim/turbo.py", "utils/constraints.py", "optim/constraints.py", "utils/sampling.py",
        "test_functions/extra.py",
    ):
        assert mod in names, mod
    csrc = {p.name for p in (ROOT / "botorch_tpu_torch" / "csrc").glob("*.cu")}
    assert csrc == {"mvn_quad_logdet.cu", "kernel_matrix.cu"}


def test_all_modules_import():
    failures = []
    for mod in pkgutil.walk_packages(botorch_tpu_torch.__path__, prefix="botorch_tpu_torch."):
        try:
            importlib.import_module(mod.name)
        except Exception as e:  # pragma: no cover
            failures.append((mod.name, repr(e)))
    assert not failures, failures


def test_precision_policy_set_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_default_to_cuda():
    from botorch_tpu_torch.settings import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    X = np.random.default_rng(0).uniform(size=(5, 2))
    Y = X.sum(-1)
    from botorch_tpu_torch.fit import fit_gp
    from botorch_tpu_torch.loop import run_bo_loop
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.optim.optimize import optimize_acqf

    with pytest.raises(RuntimeError, match="CUDA"):
        make_gp(X, Y)
    model = make_gp(X, Y, device="cpu")
    assert model.X.device.type == "cpu" and model.X.dtype == torch.float32
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_gp(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_acqf(lambda X: X.sum((-1, -2)), [[0.0, 0.0], [1.0, 1.0]], q=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_bo_loop(lambda X: X.sum(-1), d=2, n_init=3, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_bo_loop(lambda X: X.sum(-1), d=2, n_init=3, iterations=1, acqf_name="qLogNEI")


def test_mc_slice_defaults_to_cuda():
    """The qMC and sampler entry points that make tensors from nothing run
    on CUDA unless given a device; the rest follow their inputs' device."""
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a card")
    from botorch_tpu_torch.loop import bo_step, init_state
    from botorch_tpu_torch.sampling.qmc import NormalQMCEngine
    from botorch_tpu_torch.sampling.samplers import IIDNormalSampler, SobolQMCNormalSampler
    from botorch_tpu_torch.sampling.sobol import draw_sobol_normal_samples, sobol_table

    for make in (lambda: draw_sobol_normal_samples(3, 4), lambda: NormalQMCEngine(3),
                 lambda: SobolQMCNormalSampler().base_samples((2, 1)),
                 lambda: IIDNormalSampler().base_samples((2, 1))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    state, _ = init_state(3, 2, 5, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        bo_step(state, sobol_table(2), acqf_name="qLogNEI")
    assert draw_sobol_normal_samples(3, 4, device="cpu").device.type == "cpu"


def test_saasbo_slice_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a card")
    from botorch_tpu_torch.models.fully_bayesian import fit_saas_gp
    from botorch_tpu_torch.saasbo import run_saasbo
    from botorch_tpu_torch.sampling.samplers import IndexSampler

    X = np.random.default_rng(0).uniform(size=(5, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_saas_gp(X, X.sum(-1), num_warmup=2, num_samples=2, thinning=1, num_chains=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_saasbo(lambda X: X.sum(-1), d=2, n_init=3, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexSampler().indices(4)


def test_mo_slice_defaults_to_cuda():
    """The multi-objective loop's entry points run on CUDA unless given a
    device, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a card")
    from botorch_tpu_torch.mo_loop import init_mo_state, mo_bo_step, run_mo_bo_loop
    from botorch_tpu_torch.sampling.sobol import sobol_table
    from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin

    prob = BraninCurrin(negate=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mo_bo_loop(prob, d=2, m=2, ref_point=prob.ref_point, n_init=3, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mo_state(3, 2, 2, 5)
    state, _ = init_mo_state(3, 2, 2, 5, device="cpu")
    assert state.X.device.type == "cpu" and state.Y.shape == (5, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mo_bo_step(state, sobol_table(2, device="cpu"), prob.ref_point)


def test_turbo_slice_defaults_to_cuda():
    """The SVGP and TuRBO entry points run on CUDA unless given a device,
    and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a card")
    from botorch_tpu_torch.models.approximate_gp import fit_svgp, make_svgp
    from botorch_tpu_torch.optim.turbo import run_turbo, turbo_init

    X = np.random.default_rng(0).uniform(size=(8, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_svgp(X, X.sum(-1), num_inducing=4)
    model = make_svgp(X, X.sum(-1), num_inducing=4, device="cpu")
    assert model.X.device.type == "cpu" and model.X.dtype == torch.float32
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_svgp(model, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        turbo_init(0.0)
    for model_type in ("exact", "svgp"):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_turbo(lambda X: X.sum(-1), d=2, n_init=4, iterations=1, model_type=model_type)


def test_constrained_slice_defaults_to_cuda():
    """The constrained slice's entry points that make tensors from nothing
    run on CUDA unless given a device, and raise without a card; the
    samplers follow their inputs' device."""
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a card")
    from botorch_tpu_torch.optim.constraints import AffineSubspace, make_al_objective
    from botorch_tpu_torch.optim.optimize import optimize_acqf
    from botorch_tpu_torch.utils.sampling import get_polytope_samples

    eq = [((0, 1), (1.0, 1.0), 1.0)]
    with pytest.raises(RuntimeError, match="CUDA"):
        AffineSubspace.build(eq, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_al_objective(lambda V: V.sum(-1), 1, 2, equality_constraints=eq)
    with pytest.raises(RuntimeError, match="CUDA"):
        optimize_acqf(lambda X: X.sum((-1, -2)), [[0.0, 0.0], [1.0, 1.0]], q=1,
                      equality_constraints=eq)
    assert AffineSubspace.build(eq, 2, device="cpu").x0.device.type == "cpu"
    pts = get_polytope_samples(torch.Generator().manual_seed(0), 4,
                               torch.tensor([[0.0, 0.0], [1.0, 1.0]]), equality_constraints=eq)
    assert pts.device.type == "cpu" and pts.shape == (4, 2)


def test_mc_acquisition_refuses_fully_bayesian_models():
    """MC acquisition over an ensemble is a named follow-up: it raises
    rather than broadcast the ensemble dim against the t-batch."""
    from botorch_tpu_torch.acquisition.monte_carlo import (
        qLogNoisyExpectedImprovement,
        make_mc_acqf,
    )
    from botorch_tpu_torch.models.fully_bayesian import load_saas_samples
    from botorch_tpu_torch.models.gp import make_gp

    X = np.random.default_rng(0).uniform(size=(6, 2))
    base = make_gp(X, X.sum(-1), kernel="matern52", use_outputscale=True, device="cpu")
    model = load_saas_samples(torch.zeros(3, 6), base)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        make_mc_acqf(qLogNoisyExpectedImprovement, model, q=2, X_baseline=base.X)
    assert make_mc_acqf(qLogNoisyExpectedImprovement, base, q=2, X_baseline=base.X) is not None


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for a CPU tensor."""
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix
    from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet

    x = torch.zeros(3, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernel_matrix(x, x, torch.ones(2, device="meta"), "rbf")
    K = torch.zeros(2, 3, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mvn_quad_logdet(K, torch.zeros(2, 3, device="meta"))


def test_float64_is_opt_in():
    from botorch_tpu_torch.models.gp import make_gp

    X = np.random.default_rng(1).uniform(size=(4, 2))
    m = make_gp(X, X[:, 0], device="cpu", dtype=torch.float64)
    assert m.X.dtype == torch.float64 and m.params.raw_noise.dtype == torch.float64
    with pytest.raises(ValueError):
        make_gp(X, X[:, 0], device="cpu", dtype=torch.float16)
