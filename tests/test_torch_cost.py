"""gpmpc_tpu_torch.mpc.cost against gpmpc_tpu.mpc.cost at f64, rtol 1e-8:
values and gradients over B lanes with per-lane gamma (a gamma = 0 lane and a
lane that leaves the PD cone included), shared and per-lane parameters by
the rank rule, and the R_delta rate term."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.mpc import cost as jc
from gpmpc_tpu.parallel.batch import _params_axes
from gpmpc_tpu_torch.mpc import cost as tc
from torch_port_common import np_, t64

torch.set_num_threads(1)
RTOL = 1e-8


def _traj(b=5, h=4, ds=2, da=1, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (b, h + 1, ds))
    a = rng.normal(size=(b, h + 1, ds, ds)) * 0.1
    covs = a @ np.swapaxes(a, -1, -2) + 0.05 * np.eye(ds)
    covs[3] = 5.0 * np.eye(ds)      # lane 3 leaves the PD cone at gamma = -1
    u = rng.uniform(-1, 1, (b, h, da))
    return means, covs, u


def _params(lib, per_lane, rdelta, seed=1):
    rng = np.random.default_rng(seed)
    b, ds, da = 5, 2, 1
    gamma = np.array([-0.5, 0.0, 0.7, -1.0, 0.2])
    x_ref = rng.uniform(-1, 1, (b, ds) if per_lane else (ds,))
    u_ref = rng.uniform(-1, 1, (b, da) if per_lane else (da,))
    u_prev = rng.uniform(-1, 1, (b, da) if per_lane else (da,))
    q = 2.0 * np.eye(ds)
    if per_lane:
        q = q * rng.uniform(0.5, 2.0, (b, 1, 1))
    a = jnp.asarray if lib == 'jax' else t64
    return (jc.CostParams if lib == 'jax' else tc.CostParams)(
        Q=a(q), R=a(0.5 * np.eye(da)), gamma=a(gamma), x_ref=a(x_ref),
        u_ref=a(u_ref), R_delta=a(0.3 * np.eye(da)) if rdelta else None,
        u_prev=a(u_prev) if rdelta else None)


@pytest.mark.parametrize('per_lane,rdelta', [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_cost_value_and_grad_match(per_lane, rdelta):
    means, covs, u = _traj()
    jp = _params('jax', per_lane, rdelta)
    cost_b = jax.vmap(jc.risk_sensitive_cost, in_axes=(_params_axes(jp), 0, 0, 0))

    def jloss(m, c, u_):
        v = cost_b(jp, m, c, u_)
        return jnp.sum(v), v

    (_, vj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(means), jnp.asarray(covs), jnp.asarray(u))
    mt, ct, ut = (t64(v).requires_grad_() for v in (means, covs, u))
    vt = tc.risk_sensitive_cost(_params('torch', per_lane, rdelta), mt, ct, ut)
    gt = torch.autograd.grad(vt.sum(), (mt, ct, ut))
    vt, vj = np_(vt), np.asarray(vj)
    np.testing.assert_allclose(vt, vj, rtol=RTOL)
    assert vt[3] > 1e5 and np.all(np.isfinite(vt))     # the PD-cone penalty
    for got, want in zip(gt, gj):
        # The failing lane's gradient is NaN in both packages (the penalty
        # branch is selected, but the factor's NaN reaches the cotangent);
        # the solver zeroes non-finite gradients.
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-12, equal_nan=True)


def test_gamma_zero_is_the_limit():
    means, covs, u = _traj(seed=2)
    p = _params('torch', False, False)
    v0 = tc.risk_sensitive_cost(p, t64(means), t64(covs), t64(u))
    q = 2.0 * np.eye(2)
    dx = means[1] - np_(p.x_ref)
    limit = sum(np.trace(q @ covs[1, i]) + dx[i] @ q @ dx[i]
                for i in range(means.shape[1]))
    du = u[1] - np_(p.u_ref)
    limit += float(np.sum((du @ (0.5 * np.eye(1))) * du))
    np.testing.assert_allclose(float(v0[1]), limit, rtol=RTOL)
    # and the general branch tends to it as gamma -> 0
    same = tc.CostParams(**{**p._asdict(), 'gamma': t64([1e-9] * 5)})
    v_small = tc.risk_sensitive_cost(same, t64(means), t64(covs), t64(u))
    np.testing.assert_allclose(float(v_small[1]), float(v0[1]), rtol=1e-6)


def test_lane_params_rank_rule():
    """B = 1 and da == B do not confuse per-lane with shared leaves."""
    p = tc.CostParams(Q=torch.eye(1), R=torch.eye(1), gamma=torch.tensor(0.1),
                      x_ref=torch.zeros(1), u_ref=torch.zeros(1))
    lp = tc.lane_params(p, 1)
    assert lp.Q.shape == (1, 1, 1) and lp.gamma.shape == (1,)
    assert lp.x_ref.shape == (1, 1) and lp.R.shape == (1, 1)
    lp2 = tc.lane_params(lp, 1)
    assert lp2.Q.shape == (1, 1, 1) and lp2.x_ref.shape == (1, 1)


def test_shard_params_cuts_only_lane_leaves():
    """shard_params follows the same rank rule (cost.is_lane_leaf): a (B,)
    gamma and a (B, ds) x_ref are cut, a (ds, ds) Q with ds == B and R are
    not."""
    from gpmpc_tpu_torch.parallel.batch import shard_params
    p = tc.CostParams(Q=torch.eye(2), R=torch.eye(2),
                      gamma=torch.arange(2.0), x_ref=torch.ones(2, 2),
                      u_ref=torch.zeros(1))
    assert [tc.is_lane_leaf(k, v) for k, v in p._asdict().items()] == [
        False, False, True, True, False, False, False]
    sp = shard_params(p, slice(1, 2), 2)
    assert sp.Q.shape == (2, 2) and sp.R.shape == (2, 2)
    assert sp.gamma.tolist() == [1.0] and sp.x_ref.shape == (1, 2)
    assert sp.u_ref.shape == (1,)
