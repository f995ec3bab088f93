"""gpmpc_tpu_torch.mpc.solver and parallel.batch: the known answers of the JAX
package's solver tests, and at f64 on a small headline-like problem
`solve_batch` matches gpmpc_tpu's u and cost to rtol 1e-6 after 5 and 20
iterations."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.problems import make_headline_problem as jmake
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig, solve_trajectory_batched
from gpmpc_tpu_torch.parallel.batch import solve_batch
from gpmpc_tpu_torch.problems import make_headline_problem as tmake
from torch_port_common import (assert_same_solve, jit_solve,
                               nominal_gp_pair, np_, t64)

torch.set_num_threads(1)


def test_lockstep_lbfgs_on_quadratics():
    """B strongly convex quadratics with box-constrained minimizers
    x* = clip(target, -1, 1) (tests/test_batched.py)."""
    b, n = 6, 3
    targets = t64(np.random.default_rng(11).uniform(-2, 2, (b, n, 1)))
    res = solve_trajectory_batched(
        lambda x: torch.sum((x - targets) ** 2, dim=(1, 2)),
        torch.zeros((b, n, 1), dtype=torch.float64), -1.0, 1.0,
        SolverConfig(max_iters=100, tol=1e-10))
    np.testing.assert_allclose(np_(res.u), np.clip(np_(targets), -1.0, 1.0),
                               atol=1e-7)
    assert bool(res.converged.all())


def test_nonfinite_objective_survives():
    def obj(u):
        return torch.where(u[:, 0, 0] > 0.5, torch.nan, torch.sum(u ** 2, (1, 2)))

    res = solve_trajectory_batched(obj, torch.full((2, 1, 1), 0.9,
                                                   dtype=torch.float64),
                                   -1.0, 1.0, SolverConfig(max_iters=50))
    assert np.all(np.isfinite(np_(res.u)))


def test_integrator_known_answer():
    """The reference's known-answer experiment (tests/test_solver.py): the GP
    learns f(s, a) = s + a; from x0 = 5 with a in [-1, 1], the optimal H = 5
    trajectory is all -1."""
    rng = np.random.default_rng(0)
    s = rng.uniform(-10, 10, (100, 1))
    a = rng.uniform(-1, 1, (100, 1))
    gp = make_gp(GPConfig(capacity=128, x_dim=2, out_dim=1),
                 np.concatenate([s, a], 1), s + a,
                 log_lambdas=np.log([2.0, 2.0]), log_sigma_f=np.log(3.0),
                 log_sigma_n=np.log(1e-5), dtype=torch.float64, device='cpu')
    f64 = torch.float64
    params = CostParams(Q=2 * torch.eye(1, dtype=f64),
                        R=torch.zeros((1, 1), dtype=f64),
                        gamma=torch.tensor(1e-5, dtype=f64),
                        x_ref=torch.zeros(1, dtype=f64),
                        u_ref=torch.zeros(1, dtype=f64),
                        R_delta=torch.zeros((1, 1), dtype=f64),
                        u_prev=torch.zeros(1, dtype=f64))
    res = solve_batch(gp, 1, 1, torch.tensor([[5.0]], dtype=f64), params, 5,
                      -1.0, 1.0, SolverConfig(max_iters=300, tol=1e-5))
    np.testing.assert_allclose(np_(res.u).ravel(), -np.ones(5), atol=5e-3)


@pytest.mark.parametrize('max_iters', [5, 20])
def test_solve_batch_matches_jax_f64(max_iters):
    kw = dict(b=4, seed=1, n_train=24, capacity=32, horizon=5)
    jp = jmake(dtype=jnp.float64, **kw)
    tp = tmake(dtype=torch.float64, device='cpu', **kw)
    np.testing.assert_array_equal(np_(tp.x0s), np.asarray(jp.x0s))
    jres = jbatch.solve_batch(jp.gp, jp.state_dim, jp.action_dim, jp.x0s,
                              jp.params, jp.horizon, jp.lb, jp.ub,
                              JSolverConfig(max_iters=max_iters, tol=1e-4))
    tres = solve_batch(tp.gp, tp.state_dim, tp.action_dim, tp.x0s, tp.params,
                       tp.horizon, tp.lb, tp.ub,
                       SolverConfig(max_iters=max_iters, tol=1e-4))
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np_(tres.cost), np.asarray(jres.cost), rtol=1e-6)
    np.testing.assert_array_equal(np_(tres.iters), np.asarray(jres.iters))
    np.testing.assert_array_equal(np_(tres.converged), np.asarray(jres.converged))


def test_solve_batch_noise_mode_matches_jax_f64():
    """The noise-tolerant Armijo with the progress window and the best-iterate
    return, and a nonmonotone window."""
    kw = dict(b=3, seed=2, n_train=24, capacity=32, horizon=4)
    jp = jmake(dtype=jnp.float64, **kw)
    tp = tmake(dtype=torch.float64, device='cpu', **kw)
    cfg = dict(max_iters=15, tol=1e-6, noise_rel=1e-3, progress_window=4,
               nonmonotone=3)
    jres = jbatch.solve_batch(jp.gp, 2, 1, jp.x0s, jp.params, jp.horizon,
                              jp.lb, jp.ub, JSolverConfig(**cfg))
    tres = solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb,
                       tp.ub, SolverConfig(**cfg))
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np_(tres.cost), np.asarray(jres.cost), rtol=1e-6)
    np.testing.assert_array_equal(np_(tres.iters), np.asarray(jres.iters))


@pytest.mark.parametrize('case', ['adam', 'nominal'])
def test_solve_batch_auto_route_matches_jax(case):
    """F3: impl='auto' solves per scenario where the fused route cannot, as
    JAX's solve_batch does: a non-L-BFGS method (projected Adam with its
    polish, each lane its own) or a GP with a nominal model. u, cost and
    iters equal JAX's (rtol 1e-8, atol 1e-10); the port ran the lockstep
    L-BFGS whatever the method and raised on a nominal model."""
    if case == 'adam':
        kw = dict(b=3, seed=1, n_train=24, capacity=32, horizon=4)
        jp = jmake(dtype=jnp.float64, **kw)
        tp = tmake(dtype=torch.float64, device='cpu', **kw)
        jgp, tgp, x0s, horizon, lb, ub = jp.gp, tp.gp, np_(tp.x0s), 4, -5., 5.
        jparams, tparams = jp.params, tp.params
        cfg = dict(method='adam', max_iters=25, tol=1e-3, learning_rate=0.05,
                   polish_iters=5)
    else:
        jgp, tgp, rng = nominal_gp_pair()
        x0s, horizon, lb, ub = rng.uniform(-1, 1, (2, 2)), 3, -1.0, 1.0
        leaves = dict(Q=2.0 * np.eye(2), R=0.01 * np.eye(1),
                      gamma=np.array([-0.3, 0.3]), x_ref=np.zeros(2),
                      u_ref=np.zeros(1))
        jparams = JCostParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
        tparams = CostParams(**{k: t64(v) for k, v in leaves.items()})
        cfg = dict(max_iters=25, tol=1e-6)
    jres = jit_solve(lambda x0s_j, p: jbatch.solve_batch(
        jgp, 2, 1, x0s_j, p, horizon, lb, ub, JSolverConfig(**cfg)),
        jnp.asarray(x0s), jparams)
    tres = solve_batch(tgp, 2, 1, t64(x0s), tparams, horizon, lb, ub,
                       SolverConfig(**cfg))
    assert_same_solve(tres, jres)
