"""Launch arithmetic of the port's two CUDA kernels, checked on the CPU.

`k2_plan` picks K2's path and launch shape and `k1_launch` K1's; both are
pure functions of the shapes and the dtype, so they are held here to the
shapes the config-1 loop launches (K2: the fit's (2, 35, 35, 2),
`train_chol`'s (1, 35, 35, 2), the acquisition's (6, 35, 1, 2) and
(6, 1, 1, 2) and the 64 raw points' (64, 35, 1, 2) and (64, 1, 1, 2); K1:
the fit's (2, 35) and the edges of its thread blocks), to the shapes the
config-2 qLogNEI loop launches (K2 only: the fit's (2, 76, 76, 6),
`train_chol`'s (1, 76, 76, 6), and k(X_train, X_full), k(X_full, X_full)
over 76 baseline + 4 candidate points for the 64 raw q-batches and the 6
restarts) and to the limits of an H100 SXM (132 SMs, 232,448 bytes of
shared memory a block can opt into).
"""

import math

import pytest
import torch

from botorch_tpu_torch.ops.kernel_matrix import k2_plan
from botorch_tpu_torch.ops.mvn_linalg import k1_launch
from _torch_threads import _one_torch_thread  # noqa: F401


H100_SMS = 132
H100_SMEM_OPT_IN = 232_448
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,n,m,d", [(2, 35, 35, 2), (1, 35, 35, 2), (6, 35, 1, 2),
                                     (6, 1, 1, 2), (64, 35, 1, 2), (64, 1, 1, 2),
                                     (80, 35, 1, 2), (80, 1, 1, 2), (1, 64, 48, 20)])
def test_k2_narrow_path_at_the_loop_shapes(B, n, m, d, dtype):
    plan = k2_plan(B, n, m, d, dtype, H100_SMS)
    assert plan["path"] == "narrow"
    # one thread per output: blocks of 32..128 threads cover n * m, one row
    # of blocks per problem
    assert plan["threads"] in (32, 64, 96, 128)
    assert plan["grid"][0] * plan["threads"] >= n * m > (plan["grid"][0] - 1) * plan["threads"]
    assert plan["grid"][1:] == (B, 1)
    assert plan["d_bucket"] == (2 if d <= 2 else 8 if d <= 8 else 32)


def test_k2_narrow_block_is_as_small_as_the_problem():
    assert k2_plan(6, 1, 1, 2, torch.float32, H100_SMS)["threads"] == 32
    assert k2_plan(6, 35, 1, 2, torch.float32, H100_SMS)["threads"] == 64
    assert k2_plan(2, 35, 35, 2, torch.float32, H100_SMS)["threads"] == 128
    assert k2_plan(70_000, 1, 1, 2, torch.float32, H100_SMS)["grid"][1] == 65535  # the kernel strides the rest


@pytest.mark.parametrize("d,bucket", [(1, 2), (2, 2), (3, 8), (8, 8), (9, 32), (32, 32), (100, 32)])
def test_k2_feature_buckets(d, bucket):
    assert k2_plan(1, 10, 10, d, torch.float32, H100_SMS)["d_bucket"] == bucket


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_tiled_path_covers_the_sms(dtype):
    plan = k2_plan(1, 300, 257, 7, dtype, H100_SMS)
    assert plan["path"] == "tiled"
    assert plan["threads"] == 128
    # 16 * rm rows by 32 columns per block, and enough blocks for 132 SMs
    rm = plan["rows_per_thread"]
    assert plan["grid"] == (math.ceil(257 / 32), math.ceil(300 / (16 * rm)), 1)
    assert math.prod(plan["grid"]) >= 132
    assert not plan["vector_stores"]  # 257 columns: rows are not 16-byte aligned


@pytest.mark.parametrize("dtype,m,vec", [(torch.float32, 256, True), (torch.float32, 258, False),
                                         (torch.float64, 258, True), (torch.float64, 257, False)])
def test_k2_tiled_vector_stores_need_aligned_rows(dtype, m, vec):
    plan = k2_plan(4, 512, m, 3, dtype, H100_SMS)
    assert plan["path"] == "tiled" and plan["vector_stores"] is vec


# (B, n, m, d, rows_per_thread): every launch of the config-2 loop has
# 5,776-6,400 outputs per problem, above the narrow path's 4096; the 64
# raw q-batches fill the SMs with 4 rows a thread, the rest need 1
CONFIG2_K2 = [(2, 76, 76, 6, 1), (1, 76, 76, 6, 1), (64, 76, 80, 6, 4), (64, 80, 80, 6, 4),
              (6, 76, 80, 6, 1), (6, 80, 80, 6, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,n,m,d,rm", CONFIG2_K2)
def test_k2_tiled_path_at_the_config2_shapes(B, n, m, d, rm, dtype):
    plan = k2_plan(B, n, m, d, dtype, H100_SMS)
    assert plan["path"] == "tiled" and plan["threads"] == 128
    assert plan["rows_per_thread"] == rm
    assert plan["grid"] == (math.ceil(m / 32), math.ceil(n / (16 * rm)), B)
    # the first rm in (4, 2, 1) whose grid covers the SMs, else 1
    assert math.prod(plan["grid"]) >= H100_SMS or rm == 1
    assert plan["vector_stores"]  # 76 and 80 columns: 16-byte aligned rows in both dtypes


def test_k2_tiled_takes_more_rows_per_thread_when_the_grid_allows():
    assert k2_plan(1, 4096, 4096, 3, torch.float32, H100_SMS)["rows_per_thread"] == 4
    assert k2_plan(1, 100, 100, 3, torch.float32, H100_SMS)["rows_per_thread"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 32, 33, 35, 64])
@pytest.mark.parametrize("B", [1, 2, 33, 500])
def test_k1_launch_arithmetic(B, n, dtype):
    shape = k1_launch(B, n, dtype)
    size = dtype.itemsize
    # one block of 32 (n <= 32) or 64 (n > 32) threads per matrix, thread t owning row t
    assert shape["threads_per_matrix"] == (32 if n <= 32 else 64)
    assert shape["blocks"] == B
    # rows hold a chunk of 16 columns past n, start 16-byte aligned and
    # stride an odd number of 16-byte units (distinct banks for 16-byte loads)
    ld = shape["ld"]
    assert ld >= n + 15 and (ld * size) % 16 == 0 and (ld * size // 16) % 2 == 1
    assert shape["smem_bytes"] == (2 * (n + 1) + 6) * ld * size
    assert shape["smem_bytes"] <= H100_SMEM_OPT_IN


def test_k1_launch_of_an_empty_batch_and_bad_sizes():
    assert k1_launch(0, 5, torch.float32)["blocks"] == 0
    for n in (0, 65):
        with pytest.raises(ValueError):
            k1_launch(2, n, torch.float32)
