"""The PyTorch port's cyclic-reduction block-tridiagonal solver
(vista_slam_tpu_torch/ops/block_tridiag.py) against the JAX package's
factor + solve and a float64 dense solve of the same matrix, with and
without identity rows (padding and fixed nodes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_block_tridiag import _random_spd_tridiag
from vista_slam_tpu.ops.block_tridiag import factor_block_tridiag as jfactor
from vista_slam_tpu.ops.block_tridiag import solve_block_tridiag as jsolve
from vista_slam_tpu_torch.ops.block_tridiag import (factor_block_tridiag,
                                                    solve_block_tridiag, spd_inv)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# one jit per shape: a fraction of the JAX functions' op-by-op compiles
_jax_solve = jax.jit(lambda B, C, r: jsolve(jfactor(B, C), r))


@pytest.mark.parametrize("identity", [False, True], ids=["spd", "identity_rows"])
@pytest.mark.parametrize("M", [1, 2, 5, 64, 100])
def test_block_tridiag_matches_jax_and_dense(M, identity):
    rng = np.random.default_rng(M + 1000 * identity)
    fixed = tuple(i for i in (0, M // 2, M - 1) if identity and M > 2)
    B, C, dense = _random_spd_tridiag(M, 7, rng, identity_rows=fixed)
    r = rng.standard_normal((M, 7))
    x_ref = np.linalg.solve(dense, r.reshape(-1)).reshape(M, 7)

    want = np.asarray(_jax_solve(*(jnp.asarray(a, jnp.float32) for a in (B, C, r))))
    got = solve_block_tridiag(
        factor_block_tridiag(torch.tensor(B, dtype=torch.float32),
                             torch.tensor(C, dtype=torch.float32)),
        torch.tensor(r, dtype=torch.float32)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, x_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for i in fixed:  # identity rows return their rhs
        np.testing.assert_allclose(got[i], r[i], rtol=1e-5, atol=1e-6)


def test_spd_inv_inverts_spd_blocks():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((50, 7, 7))
    spd = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(7)
    got = spd_inv(torch.tensor(spd, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got @ spd, np.broadcast_to(np.eye(7), spd.shape),
                               atol=2e-4)
