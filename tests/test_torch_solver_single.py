"""gpmpc_tpu_torch.mpc.solver.solve_trajectory against gpmpc_tpu's at f64
(the counterparts of tests/test_solver.py:16-60): L-BFGS (the lockstep
solver at B = 1) and Adam with and without its polish, on the unconstrained
and box-active quadratics, a non-finite region and an uncertain-rollout
objective; u, cost and iters equal to JAX's (rtol 1e-8)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu import dynamics as jd
from gpmpc_tpu.mpc import cost as jcost
from gpmpc_tpu.mpc.solver import SolverConfig as JConfig
from gpmpc_tpu.mpc.solver import solve_trajectory as jsolve
from gpmpc_tpu_torch import dynamics as td
from gpmpc_tpu_torch.mpc.controller import single_cost
from gpmpc_tpu_torch.mpc.solver import SolverConfig, solve_trajectory
from torch_port_common import cost_params_pair, jax_gp, np_, port_gp, t64

torch.set_num_threads(1)
RTOL = 1e-8
METHODS = [dict(method='lbfgs'), dict(method='adam'),
           dict(method='adam', polish_iters=20, learning_rate=0.05)]


def _both(j_obj, t_obj, u0, lb, ub, **cfg):
    jres = jsolve(j_obj, jnp.asarray(u0), lb, ub, JConfig(**cfg))
    tres = solve_trajectory(t_obj, t64(u0), lb, ub, SolverConfig(**cfg))
    return jres, tres


def _assert_same(tres, jres, rtol=RTOL):
    assert int(tres.iters) == int(jres.iters)
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), rtol=rtol,
                               atol=1e-12)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=rtol,
                               atol=1e-14)
    np.testing.assert_allclose(float(tres.pg_norm), float(jres.pg_norm),
                               rtol=1e-6, atol=1e-12)
    assert (tres.converged is None) == (jres.converged is None)
    if jres.converged is not None:
        assert bool(tres.converged) == bool(jres.converged)


@pytest.mark.parametrize('cfg', METHODS)
def test_unconstrained_quadratic(cfg):
    target = np.random.default_rng(9).uniform(-0.5, 0.5, (4, 2))
    jres, tres = _both(lambda u: jnp.sum((u - target) ** 2),
                       lambda u: torch.sum((u - t64(target)) ** 2),
                       np.zeros((4, 2)), -1.0, 1.0, max_iters=500, tol=1e-6,
                       **cfg)
    _assert_same(tres, jres)
    if cfg['method'] == 'lbfgs':
        np.testing.assert_allclose(np_(tres.u), target, atol=1e-4)
        assert float(tres.pg_norm) < 1e-5


@pytest.mark.parametrize('cfg', METHODS)
def test_active_box_constraints(cfg):
    target = np.array([[2.0, -3.0], [0.5, 0.0]])
    jres, tres = _both(lambda u: jnp.sum((u - target) ** 2),
                       lambda u: torch.sum((u - t64(target)) ** 2),
                       np.zeros((2, 2)), -1.0, 1.0, max_iters=500, tol=1e-6,
                       **cfg)
    _assert_same(tres, jres)
    np.testing.assert_allclose(np_(tres.u), [[1.0, -1.0], [0.5, 0.0]],
                               atol=2e-2 if cfg['method'] == 'adam' else 1e-4)


@pytest.mark.parametrize('cfg', METHODS[:2])
def test_nonfinite_region(cfg):
    """A NaN objective above u = 0.5: the iterate stays finite, as JAX's."""
    jres, tres = _both(
        lambda u: jnp.where(u[0, 0] > 0.5, jnp.nan, jnp.sum(u ** 2)),
        lambda u: torch.where(u[0, 0] > 0.5, torch.nan, torch.sum(u ** 2)),
        np.full((1, 1), 0.9), -1.0, 1.0, max_iters=50, **cfg)
    assert np.all(np.isfinite(np_(tres.u)))
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), rtol=RTOL,
                               atol=1e-12)


@pytest.mark.parametrize('cfg', [METHODS[0], METHODS[2]])
def test_rollout_objective(cfg):
    """The uncertain single-scenario rollout plus the risk-sensitive cost of
    a small GP (delta dynamics), the controller's route (c)."""
    jgp = jax_gp(n=24, cap=32)
    tgp = port_gp(jgp)
    jcache, tcache = jd.build_rollout_cache(jgp, 2, 1), td.build_rollout_cache(tgp, 2, 1)
    leaves = dict(Q=np.diag([2.0, 1.0]), R=0.1 * np.eye(1), gamma=np.array(0.2),
                  x_ref=np.zeros(2), u_ref=np.zeros(1), R_delta=0.05 * np.eye(1),
                  u_prev=np.array([0.3]))
    jp, tp = cost_params_pair(leaves)
    x0 = np.array([0.5, -0.3])

    def j_obj(u):
        means, covs = jd.rollout(jcache, jnp.asarray(x0), u, delta=True)
        return jcost.risk_sensitive_cost(jp, means, covs, u)

    def t_obj(u):
        means, covs = td.rollout(tcache, t64(x0), u, delta=True)
        return single_cost(tp, means, covs, u)

    jres, tres = _both(j_obj, t_obj, np.zeros((3, 1)), -2.0, 2.0,
                       max_iters=40, tol=1e-6, **cfg)
    _assert_same(tres, jres, rtol=1e-7)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        solve_trajectory(lambda u: torch.sum(u ** 2), torch.zeros(2, 1), -1,
                         1, SolverConfig(method='sgd'))
