"""The FITC sparse GP on the solve path against gpmpc_tpu at f64: the
batched rollout on a sparse state with diagonal and full covariance (values
and gradients; the variance trace on W's b_lam), and the suite's sparse
problems (configs 3b and 4, problems.make_sparse_cartpole_problem and
make_sparse_fullcov_problem) against benchmarks/problems.py's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks import problems as jproblems
from gpmpc_tpu import dynamics as jd
from gpmpc_tpu.gp import sparse as jsp
from gpmpc_tpu_torch import dynamics as td
from gpmpc_tpu_torch import problems as tproblems
from gpmpc_tpu_torch.gp import sparse as tsp
from torch_port_common import np_, t64
from test_torch_sparse import (ATOL, POSTERIOR_TOL, RTOL, _hp,
                               assert_close_to_max)

torch.set_num_threads(1)
RNG = np.random.default_rng(53)


def _fit_both(z, x, y, hp):
    return (jsp.fit_sparse(*(jnp.asarray(v) for v in (z, x, y.T) + hp))[0],
            tsp.fit_sparse(*(t64(v) for v in (z, x, y.T) + hp))[0])


def _rollout_data(n=150, m=32):
    rng = np.random.default_rng(52)
    states = rng.uniform(-1, 1, (n, 2))
    actions = rng.uniform(-1, 1, (n, 1))
    nxt = 0.95 * states + 0.1 * np.concatenate([actions, actions], axis=1)
    x = np.concatenate([states, actions], axis=1)
    z = x[rng.choice(n, m, replace=False)]
    return z, x, nxt - states


@pytest.mark.parametrize('full_cov', [False, True])
def test_rollout_batched_on_sparse_state(full_cov):
    """A sparse state drives the batched rollout (the variance trace on
    W's b_lam) with diagonal and full covariance: means, covariances and the
    gradient of their sum equal JAX's."""
    z, x, deltas = _rollout_data()
    js, ts = _fit_both(z, x, deltas, _hp(2, 3, lam=3.0, sf=0.5))
    x0s = RNG.uniform(-0.5, 0.5, (3, 2))
    us = RNG.uniform(-1, 1, (3, 6, 1))
    jc = jd.build_rollout_cache(js, 2, 1)

    def jf(u):
        m, c = jd.rollout_batched(jc, jnp.asarray(x0s), u, delta=True,
                                  full_cov=full_cov)
        return jnp.sum(m) + 10.0 * jnp.sum(c), (m, c)

    (_, (mj, cj)), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(us))
    ut = t64(us).requires_grad_()
    mt, ct = td.rollout_batched(td.build_rollout_cache(ts, 2, 1), t64(x0s), ut,
                                delta=True, full_cov=full_cov)
    (gt,) = torch.autograd.grad(torch.sum(mt) + 10.0 * torch.sum(ct), ut)
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=1e-7, atol=ATOL)
    np.testing.assert_allclose(np_(gt), np.asarray(gj), rtol=1e-7, atol=1e-9)
    assert np.all(np.diagonal(np_(ct), axis1=2, axis2=3) >= 0)


@pytest.mark.parametrize('name', ['3b_sparse_cartpole', '4_sparse_fullcov'])
def test_problem_makers_match_jax(name):
    """The suite's sparse workloads at a small B and horizon: the same data,
    inducing rows, f64 FITC posterior (to POSTERIOR_TOL of its largest
    entry), start states and cost, and the f64 objective at random controls
    equal to JAX's (rtol 1e-8)."""
    wl = tproblems.SPARSE_WORKLOADS[name]
    jp = getattr(jproblems, wl['maker'])(b=3, dtype=jnp.float64, horizon=4)
    tp = getattr(tproblems, wl['maker'])(b=3, dtype=torch.float64, horizon=4,
                                         device='cpu')
    np.testing.assert_array_equal(np_(tp.gp.x), np.asarray(jp.gp.x))
    for k in ('beta', 'kinv'):
        assert_close_to_max(getattr(tp.gp, k), getattr(jp.gp, k),
                            POSTERIOR_TOL, err_msg=k)
    assert tp.gp.config.tied_lambdas
    np.testing.assert_array_equal(np_(tp.x0s), np.asarray(jp.x0s))
    for k in ('Q', 'R', 'gamma', 'x_ref', 'u_ref'):
        np.testing.assert_array_equal(np_(getattr(tp.params, k)),
                                      np.asarray(getattr(jp.params, k)))
    assert (tp.lb, tp.ub, tp.horizon) == (jp.lb, jp.ub, jp.horizon)
    u = RNG.uniform(tp.lb, tp.ub, (3, 4, 1)) * 0.3
    jc = jd.build_rollout_cache(jp.gp, jp.state_dim, jp.action_dim)
    from gpmpc_tpu.mpc.cost import risk_sensitive_cost as jcost
    from gpmpc_tpu.parallel.batch import _params_axes
    mj, cj = jd.rollout_batched(jc, jp.x0s, jnp.asarray(u),
                                full_cov=wl['full_cov'])
    jj = jax.vmap(jcost, in_axes=(_params_axes(jp.params), 0, 0, 0))(
        jp.params, mj, cj, jnp.asarray(u))
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    tj = batch_objective(td.build_rollout_cache(tp.gp, tp.state_dim,
                                                tp.action_dim), tp.x0s,
                         tp.params, full_cov=wl['full_cov'])(t64(u))
    np.testing.assert_allclose(np_(tj), np.asarray(jj), rtol=RTOL)
