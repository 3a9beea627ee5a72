"""Port's extension DP (gaml_tpu_torch.ops.extend, .extend_cuda) against
the JAX package: constants, the exact DP bit for bit, and the K1/K2
plain versions under the kernels' contract."""
import numpy as np
import torch

import jax.numpy as jnp

import gaml_tpu.ops.extend as jext
from gaml_tpu.ops.extend_pallas import (BLOCK_CANDS, block_bounds,
                                        block_layout,
                                        swar_cost_accept_pallas,
                                        swar_cost_pallas)
from gaml_tpu_torch.ops import extend as text
from gaml_tpu_torch.ops.extend_cuda import (swar_cost_accept_ref,
                                            swar_cost_ref)

from test_torch_kernels import random_band_inputs


def test_constants_match_jax():
    for name in ("K", "PAD", "BAND", "INF", "INVALID_A", "ERROR_LIMIT",
                 "SENT_READ", "SENT_GEN"):
        assert getattr(text, name) == getattr(jext, name), name


def test_dp_rows_bit_equal_to_jax():
    read, gwin, rlen, glen = random_band_inputs(1, 1500, 24)
    rlen[:50] = 0
    glen[50:100] = np.arange(50) % 5  # genome ends within the band
    c_j, a_j = jext._dp_rows(jnp.asarray(read.T), jnp.asarray(rlen),
                             jnp.asarray(gwin.T), jnp.asarray(glen), 24)
    c_t, a_t = text.dp_rows(torch.from_numpy(read.T.copy()),
                            torch.from_numpy(rlen),
                            torch.from_numpy(gwin.T.copy()),
                            torch.from_numpy(glen), 24)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


def test_plain_versions_match_jax_kernels():
    """K1/K2 plain versions against the Pallas kernels (interpret mode,
    their block layout and row bounds) under the contract: cost equal
    (both saturate at 7), accept offset equal wherever the exact cost is
    <= 6."""
    n, rmax = BLOCK_CANDS, 32
    read, gwin, rlen, glen = random_band_inputs(0, n, rmax)
    order = np.argsort(rlen, kind="stable")
    perm = order[block_layout(n)]
    nrows = block_bounds(rlen[order])
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    args_j = (jnp.asarray(read[:, perm].astype(np.int32)),
              jnp.asarray(gwin[:, perm].astype(np.int32)),
              jnp.asarray(rlen[perm]), jnp.asarray(glen[perm]))
    c1_j = np.asarray(swar_cost_pallas(*args_j, rmax, jnp.asarray(nrows),
                                       interpret=True))[inv]
    c2_j, a2_j = swar_cost_accept_pallas(*args_j, rmax, jnp.asarray(nrows),
                                         interpret=True)
    c2_j, a2_j = np.asarray(c2_j)[inv], np.asarray(a2_j)[inv]

    args_t = tuple(torch.from_numpy(x) for x in (read, gwin, rlen, glen))
    c1_t = swar_cost_ref(*args_t).numpy()
    c2_t, a2_t = (t.numpy() for t in swar_cost_accept_ref(*args_t))
    c_exact, _ = text.dp_rows(args_t[0].t(), args_t[2], args_t[1].t(),
                              args_t[3], rmax)
    c_exact = c_exact[:, 3].numpy()

    np.testing.assert_array_equal(c1_t, c1_j)
    np.testing.assert_array_equal(c2_t, c2_j)
    np.testing.assert_array_equal(c1_t, np.minimum(c_exact, 7))
    m = c_exact <= 6
    assert m.sum() > n // 4
    np.testing.assert_array_equal(a2_t[m], a2_j[m])
