"""chip_smoke.py's phase 8 parity checks on the CPU against the stored JAX
results (gpmpc_tpu_torch/data/sparse_ref.npz, written by
tests/make_torch_sparse_ref.py): suite config 3b's f64 FITC posterior and
its f64 objective and gradient at the f64 reference controls, config 4's at
H = 50 with full covariance, the per-scenario routes (Adam through 'auto',
solve_batch_gp over stack_gps draws) and the uncertainty experiment at its
published settings, each at the bars chip_smoke.py holds the card to (the
kernel launch counts are the card's and are not read here)."""

import numpy as np
import pytest
import torch

import chip_smoke
from gpmpc_tpu_torch.problems import SPARSE_REF_FILE

torch.set_num_threads(2)
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def ref():
    return np.load(SPARSE_REF_FILE)


@pytest.mark.parametrize('tag, name, bars, carried', [
    ('3b', '3b_sparse_cartpole', '3b', False),
    ('4', '4_sparse_fullcov', '4 own fit', False),
    ('4', '4_sparse_fullcov', '4 carried', True)])
def test_sparse_objective_parity(ref, tag, name, bars, carried):
    """The f64 FITC posterior, J and dJ/du at 0 and u_ref against JAX's at
    the card's bars (chip_smoke.SPARSE_BARS, which state the CPU's
    readings)."""
    _, j, out = chip_smoke.sparse_objective_parity(
        tag, name, ref, CPU, chip_smoke.SPARSE_BARS[bars], carried)
    assert j.shape == ref[f'{tag}_j_uref'].shape
    assert bool(torch.isfinite(j).all())


def test_vmap_routes(ref):
    out = chip_smoke.phase_vmap_routes(CPU, ref)
    assert out['adam']['iters'] == ref['adam_iters'].tolist()
    assert out['gp']['u_max_abs_err'] <= chip_smoke.VMAP_U_ATOL


def test_uncertainty(ref):
    out, mpc, u = chip_smoke.phase_uncertainty(CPU, ref)
    assert mpc.gp.config.tied_lambdas and u.shape == (6, 2)
    for r in out.values():
        assert r['u_max_abs_err'] <= chip_smoke.UNC_ATOL
