"""The port's slice as a whole: make_headline_problem builds the same problem
as the JAX package, the port's f64 objective matches the JAX f64 objective
stored in gpmpc_tpu_torch/data/headline_ref.npz (rtol 1e-8, 8 lanes), and the
package (its sharded modules, its probes and chip_smoke.py included) stays
apart from JAX and from the JAX package's top-level `benchmarks`."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.problems import make_headline_problem as jmake
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.parallel.batch import batch_objective
from gpmpc_tpu_torch.problems import make_headline_problem as tmake
from torch_port_common import np_, t64

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'gpmpc_tpu_torch', 'data', 'headline_ref.npz')
LANES = 8


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_headline_problem_matches_jax(dtype):
    jp = jmake(b=16, dtype=getattr(jnp, dtype))
    tp = tmake(b=16, dtype=getattr(torch, dtype), device='cpu')
    rtol = 1e-6 if dtype == 'float32' else 1e-8
    for name in ('x', 'y', 'mask', 'count', 'log_lambdas', 'log_sigma_f',
                 'log_sigma_n', 'kinv', 'beta', 'logdet', 'jitter_used'):
        np.testing.assert_allclose(np_(getattr(tp.gp, name)).astype(np.float64),
                                   np.asarray(getattr(jp.gp, name), np.float64),
                                   rtol=rtol, atol=1e-12, err_msg=name)
    assert tp.gp.config.tied_lambdas and jp.gp.config.tied_lambdas
    np.testing.assert_array_equal(np_(tp.x0s), np.asarray(jp.x0s))
    for name in ('Q', 'R', 'gamma', 'x_ref', 'u_ref'):
        np.testing.assert_array_equal(np_(getattr(tp.params, name)),
                                      np.asarray(getattr(jp.params, name)))
    assert (tp.state_dim, tp.action_dim, tp.horizon, tp.lb, tp.ub) == (
        jp.state_dim, jp.action_dim, jp.horizon, jp.lb, jp.ub)


def test_f64_objective_matches_stored_jax_reference():
    ref = np.load(REF)
    tp = tmake(b=256, dtype=torch.float64, device='cpu')
    params = tp.params._replace(gamma=tp.params.gamma[:LANES])
    j64 = batch_objective(build_rollout_cache(tp.gp, 2, 1), tp.x0s[:LANES],
                          params)
    np.testing.assert_allclose(np_(j64(t64(ref['u_ref'][:LANES]))),
                               ref['j_uref'][:LANES], rtol=1e-8)
    u0 = torch.zeros((LANES, 20, 1), dtype=torch.float64, requires_grad=True)
    j0 = j64(u0)
    (g0,) = torch.autograd.grad(j0.sum(), u0)
    np.testing.assert_allclose(np_(j0), ref['j_zero'][:LANES], rtol=1e-8)
    np.testing.assert_allclose(np_(g0), ref['grad_zero'], rtol=1e-8, atol=1e-10)


_ISOLATION = r'''
import importlib, pkgutil, sys, torch
import gpmpc_tpu_torch
for m in pkgutil.walk_packages(gpmpc_tpu_torch.__path__, 'gpmpc_tpu_torch.'):
    importlib.import_module(m.name)
for name in ('parallel.mesh', 'parallel.model_sharded', 'parallel.distributed',
             'parallel.batch', 'ops.kernels.variance_trace', 'ops.kernels.probe',
             'benchmarks.chain', 'benchmarks.kernel_ablate',
             'benchmarks.kernel_probe'):
    importlib.import_module('gpmpc_tpu_torch.' + name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'gpmpc_tpu', 'flax',
                                    'benchmarks'))
print('LEAKED', bad)
try:
    p = gpmpc_tpu_torch.make_headline_problem(b=2)
    print('DEFAULT_DEVICE', p.x0s.device.type)
except RuntimeError as e:
    print('RAISED', 'device' in str(e))
'''


def test_port_imports_no_jax_and_defaults_to_cuda():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', _ISOLATION], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert 'LEAKED []' in out.stdout, out.stdout
    if torch.cuda.is_available():
        assert 'DEFAULT_DEVICE cuda' in out.stdout, out.stdout
    else:
        assert 'RAISED True' in out.stdout, out.stdout
