"""Port parity: `sampling/sobol` of botorch_tpu_torch is bit-exact with
botorch_tpu (tables, raw bits, floats), including `skip` and its uint32
wrap-around."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.sampling import sobol as js
from botorch_tpu_torch.sampling import sobol as ts
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dim,scramble,seed", [(1, False, None), (2, True, 0),
                                               (6, True, 17), (40, True, 3)])
def test_tables_identical(dim, scramble, seed):
    sv_t, sh_t = ts.sobol_table(dim, scramble=scramble, seed=seed)
    sv_j, sh_j = js.sobol_table(dim, scramble=scramble, seed=seed)
    np.testing.assert_array_equal(sv_t.numpy(), np.asarray(sv_j).astype(np.int64))
    np.testing.assert_array_equal(sh_t.numpy(), np.asarray(sh_j).astype(np.int64))


@pytest.mark.parametrize("skip", [0, 1, 64, 2112, 2**31 + 5, 2**32 - 3])
def test_bits_and_floats_bit_exact(skip):
    sv_t, sh_t = ts.sobol_table(3, scramble=True, seed=5)
    sv_j, sh_j = js.sobol_table(3, scramble=True, seed=5)
    bits_t = ts.draw_sobol_bits(sv_t, sh_t, 100, skip=skip)
    bits_j = js.draw_sobol_bits(sv_j, sh_j, 100, jnp.uint32(skip))
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j).astype(np.int64))
    u_t = ts.draw_sobol(sv_t, sh_t, 100, skip=skip)
    u_j = js.draw_sobol(sv_j, sh_j, 100, skip=jnp.uint32(skip))
    assert u_t.dtype == torch.float32
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    assert float(u_t.min()) > 0.0 and float(u_t.max()) < 1.0


def test_skip_continues_the_stream():
    sv, sh = ts.sobol_table(2, seed=4)
    long = ts.draw_sobol_bits(sv, sh, 96)
    np.testing.assert_array_equal(ts.draw_sobol_bits(sv, sh, 32, skip=64).numpy(),
                                  long[64:].numpy())


def test_draw_sobol_samples_box():
    bounds_np = np.array([[-5.0, 0.0], [10.0, 15.0]], np.float32)
    xt = ts.draw_sobol_samples(torch.tensor(bounds_np), n=16, q=3, seed=9)
    xj = js.draw_sobol_samples(jnp.asarray(bounds_np), 16, 3, seed=9)
    assert xt.shape == (16, 3, 2)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6, atol=1e-6)


def test_float64_draws():
    sv, sh = ts.sobol_table(2, seed=1)
    u64 = ts.draw_sobol(sv, sh, 32, dtype=torch.float64)
    u32 = ts.draw_sobol(sv, sh, 32)
    assert u64.dtype == torch.float64
    np.testing.assert_array_equal(u64.numpy().astype(np.float32), u32.numpy())
