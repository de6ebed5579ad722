"""Port parity: the row gather of the K3 probe (funky_tpu_torch/ops/
gather_cuda.py::row_gather). On the CPU it is its plain twin, take_rows;
here it is held against numpy and against the JAX package's take_rows
(funky_tpu/ops/sampling.py:31-61), which the frame's samplers use.

Tolerance: none; a gather copies values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funky_tpu.ops.sampling import take_rows as jtake_rows

from funky_tpu_torch.ops import gather_cuda

from .torch_parity import t2n


@pytest.mark.parametrize("width", [1, 2, 4, 7])
def test_row_gather_matches_numpy_and_jax(width):
    """Random rows, out-of-range and negative indices (counted from the
    end, then clamped), a 2-D index batch."""
    rng = np.random.default_rng(width)
    n = 1000
    table = rng.random((n, width)).astype(np.float32)
    idx = rng.integers(-2 * n, 2 * n, (37, 11)).astype(np.int32)
    before = gather_cuda.LAUNCHES
    got = t2n(gather_cuda.row_gather(torch.from_numpy(table),
                                     torch.from_numpy(idx)))
    assert gather_cuda.LAUNCHES == before     # the CPU takes the plain twin
    want = table[np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jtake_rows(jnp.asarray(table), jnp.asarray(idx))))
    assert got.shape == idx.shape + (width,)
