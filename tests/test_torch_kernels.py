"""Kernels K1/K2 of the port (gaml_tpu_torch.ops.extend_cuda): the
wrappers' CPU route and input checks, and on a CUDA card the kernels
against their plain versions.  Imports no jax, so the card test runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from gaml_tpu_torch.ops.extend import PAD, SENT_GEN, SENT_READ
from gaml_tpu_torch.ops.extend_cuda import (swar_cost, swar_cost_accept,
                                            swar_cost_accept_ref,
                                            swar_cost_ref)


def random_band_inputs(seed, n, rmax):
    """Candidate-minor kernel inputs as the JAX kernel tests build them:
    half the candidates matching, sentinels, ragged rlen and short glen
    (rlen 0 included)."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 5, (rmax, n)).astype(np.uint8)
    gwin = rng.integers(0, 5, (rmax + 2 * PAD, n)).astype(np.uint8)
    gwin[PAD:PAD + rmax, :n // 2] = read[:, :n // 2]
    gwin[gwin == 4] = SENT_GEN
    read[read == 4] = SENT_READ
    rlen = rng.integers(0, rmax + 1, n).astype(np.int32)
    glen = rng.integers(0, rmax + PAD, n).astype(np.int32)
    return read, gwin, rlen, glen


def test_wrappers_take_plain_version_on_cpu_and_check_inputs():
    read, gwin, rlen, glen = (torch.from_numpy(x) for x in
                              random_band_inputs(2, 300, 16))
    assert torch.equal(swar_cost(read, gwin, rlen, glen),
                       swar_cost_ref(read, gwin, rlen, glen))
    for got, want in zip(swar_cost_accept(read, gwin, rlen, glen),
                         swar_cost_accept_ref(read, gwin, rlen, glen)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        swar_cost(read.to(torch.int32), gwin, rlen, glen)
    with pytest.raises(ValueError):
        swar_cost_accept(read, gwin[:-1], rlen, glen)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["swar_cost", "swar_cost_accept"])
def test_kernel_matches_plain_version_on_card(kernel):
    """K1/K2 on the card against their plain versions on the same
    inputs, at the main path's shape (n = 131072, rmax = 96)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    args = tuple(torch.from_numpy(x).cuda() for x in
                 random_band_inputs(3, 131072, 96))
    if kernel == "swar_cost":
        assert torch.equal(swar_cost(*args), swar_cost_ref(*args))
        return
    c, a = swar_cost_accept(*args)
    c_ref, a_ref = swar_cost_accept_ref(*args)
    assert torch.equal(c, c_ref)
    m = c_ref <= 6
    assert torch.equal(a[m], a_ref[m])
