"""gpmpc_tpu_torch.utils.checkpoint, utils.metrics and native against
gpmpc_tpu's (the counterparts of tests/test_aux.py): GP and controller
checkpoints round-trip in the port and across the packages both ways
(JAX-written into the port, port-written into JAX), equal to the bit; the
metrics sink; and the native box solver built from native/box_solver.cpp
into gpmpc_tpu_torch/_build/, against the port's own solver on the
integrator objective (skipping without a C++ toolchain)."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.gp import sparse as jsp
from gpmpc_tpu.gp.exact import predict as jpredict
from gpmpc_tpu.mpc.controller import RiskSensitiveMPC as JMPC
from gpmpc_tpu.utils import checkpoint as jckpt
from gpmpc_tpu_torch import native
from gpmpc_tpu_torch.gp.exact import predict
from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC as TMPC
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.utils import checkpoint as ckpt
from gpmpc_tpu_torch.utils.metrics import JsonlLogger, episode_summary
from torch_port_common import np_, t64

torch.set_num_threads(1)
RNG = np.random.default_rng(13)
FIELDS = ckpt._ARRAY_FIELDS


def _data():
    rng = np.random.default_rng(13)
    return rng.uniform(-1, 1, (20, 3)), rng.normal(size=(20, 2))


def test_gp_roundtrip_in_port(tmp_path):
    x, y = _data()
    gp = make_gp(GPConfig(capacity=32, x_dim=3, out_dim=2), x, y,
                 log_sigma_n=np.log(0.1), dtype=torch.float64, device='cpu')
    p = str(tmp_path / 'gp.npz')
    ckpt.save_gp(p, gp)
    gp2 = ckpt.load_gp(p, device='cpu')
    for f in FIELDS:
        torch.testing.assert_close(getattr(gp2, f), getattr(gp, f), rtol=0,
                                   atol=0)
    assert gp2.config == gp.config and int(gp2.count) == 20
    xp = t64(RNG.uniform(-1, 1, (4, 3)))
    for a, b in zip(predict(gp, xp), predict(gp2, xp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ckpt.load_gp(p, dtype=torch.float32, device='cpu').x.dtype == \
        torch.float32


@pytest.mark.parametrize('kind', ['exact', 'sparse'])
def test_gp_checkpoints_cross_packages(tmp_path, kind):
    """A JAX-written checkpoint loads into the port with every array equal
    (a FITC state too: kinv = W), and predicts as JAX does; the port's
    re-save loads into JAX to the bit."""
    x, y = _data()
    if kind == 'exact':
        jgp = gs.make_gp(gs.GPConfig(capacity=32, x_dim=3, out_dim=2), x, y,
                         log_sigma_n=np.log(0.1), dtype=jnp.float64)
    else:
        jgp, _ = jsp.fit_sparse(jnp.asarray(x[:8]), jnp.asarray(x),
                                jnp.asarray(y.T), jnp.zeros((2, 3)),
                                jnp.zeros(2), jnp.log(jnp.full(2, 0.1)))
    pj, pt = str(tmp_path / 'jax.npz'), str(tmp_path / 'port.npz')
    jckpt.save_gp(pj, jgp)
    tgp = ckpt.load_gp(pj, device='cpu')
    for f in FIELDS:
        np.testing.assert_array_equal(np_(getattr(tgp, f)),
                                      np.asarray(getattr(jgp, f)), err_msg=f)
    assert tgp.config.tied_lambdas and tgp.x.dtype == torch.float64
    xp = RNG.uniform(-1, 1, (4, 3))
    for a, b in zip(predict(tgp, t64(xp)), jpredict(jgp, jnp.asarray(xp))):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    ckpt.save_gp(pt, tgp)
    back = jckpt.load_gp(pt)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jgp, f)), err_msg=f)
    assert back.config.capacity == jgp.config.capacity


def test_nominal_fn_guard(tmp_path):
    def f_nom(xs):
        return xs[:, :1]

    gp = make_gp(GPConfig(capacity=8, x_dim=2, out_dim=1, nominal_fn=f_nom),
                 RNG.uniform(-1, 1, (5, 2)), RNG.normal(size=(5, 1)),
                 dtype=torch.float64, device='cpu')
    p = str(tmp_path / 'gp.npz')
    ckpt.save_gp(p, gp)
    with pytest.raises(ValueError, match='nominal'):
        ckpt.load_gp(p, device='cpu')
    assert ckpt.load_gp(p, nominal_fn=f_nom,
                        device='cpu').config.nominal_fn is f_nom


CTRL = dict(gamma=-0.5, horizon=4, state_dim=2, input_dim=1, Q=2 * np.eye(2),
            R=0.1 * np.eye(1), R_delta=0.2 * np.eye(1), capacity=32,
            delta_dynamics=True)


def _fill(mpc):
    rng = np.random.default_rng(14)
    s = rng.uniform(-1, 1, (10, 2))
    a = rng.uniform(-1, 1, (10, 1))
    mpc.dynamics.append_train_data(s, a, 0.9 * s)
    mpc.set_ub([2.0])
    mpc.set_lb([-2.0])
    mpc.last_traj = rng.normal(size=(4, 1))
    return mpc


def test_controller_roundtrip_in_port(tmp_path):
    mpc = _fill(TMPC(dtype=torch.float64, device='cpu', **CTRL))
    base = str(tmp_path / 'ctrl')
    ckpt.save_controller(base, mpc)
    mpc2 = ckpt.load_controller(base, device='cpu')
    assert mpc2.gamma == -0.5 and mpc2.delta_dynamics
    np.testing.assert_array_equal(mpc2.last_traj, mpc.last_traj)
    u1 = mpc.get_optimal_trajectory(np.array([0.5, -0.5]))
    u2 = mpc2.get_optimal_trajectory(np.array([0.5, -0.5]))
    np.testing.assert_allclose(u1, u2, atol=1e-12)


def test_controller_checkpoints_cross_packages(tmp_path):
    """A JAX-written controller resumes in the port with JAX's next actions
    (tests/test_torch_controller.py's bar, rtol 1e-6, atol 1e-7), and a
    port-written one resumes in JAX with the port's."""
    jm = _fill(JMPC(dtype=jnp.float64, **CTRL))
    base = str(tmp_path / 'jax')
    jckpt.save_controller(base, jm)
    tm = ckpt.load_controller(base, device='cpu')
    np.testing.assert_array_equal(tm.last_traj, jm.last_traj)
    np.testing.assert_array_equal(np_(tm.R_delta), np.asarray(jm.R_delta))
    x0 = np.array([0.5, -0.5])
    np.testing.assert_allclose(tm.get_optimal_trajectory(x0),
                               jm.get_optimal_trajectory(x0), rtol=1e-6,
                               atol=1e-7)
    base = str(tmp_path / 'port')
    ckpt.save_controller(base, tm)
    jm2 = jckpt.load_controller(base)
    np.testing.assert_array_equal(jm2.last_traj, tm.last_traj)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jm2.gp, f)),
                                      np_(getattr(tm.gp, f)), err_msg=f)
    np.testing.assert_allclose(jm2.get_optimal_trajectory(x0),
                               tm.get_optimal_trajectory(x0), rtol=1e-6,
                               atol=1e-7)


def test_jsonl_logger_and_summary(tmp_path):
    from gpmpc_tpu_torch.mpc.solver import SolveResult
    from gpmpc_tpu_torch.sim.simulator import EpisodeLog
    p = str(tmp_path / 'm.jsonl')
    lg = JsonlLogger(p)
    lg.log(dict(kind='x', v=1))
    lg.log_solve(3, SolveResult(u=torch.zeros(2, 4, 1),
                                cost=t64([1.0, 3.0]), iters=torch.tensor([4, 6]),
                                pg_norm=t64([1e-5, 2e-5])))
    log = EpisodeLog(states=np.zeros((6, 2)), actions=np.zeros((5, 1)),
                     rewards=np.ones(5), solve_times=np.full(5, 0.01),
                     costs=np.arange(5.0), iters=np.full(5, 20))
    lg.log_episode(log)
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]['kind'] == 'x' and 't' in lines[0]
    assert lines[1] == dict(kind='solve', step=3, cost_mean=2.0, cost_max=3.0,
                            iters_mean=5.0, pg_norm_max=2e-5, batch=2,
                            t=lines[1]['t'])
    assert lines[2]['steps'] == 5 and lines[2]['final_cost'] == 4.0
    s = episode_summary(log)
    assert s['steps'] == 5 and abs(s['solves_per_s'] - 100.0) < 1e-6


def test_native_box_qp_builds_into_port():
    if not native.available():
        pytest.skip('no C++ toolchain')
    lib = native.library_path()
    assert lib.parent.name == '_build' and lib.parent.parent.name == \
        'gpmpc_tpu_torch' and lib.exists()
    target = np.array([2.0, -3.0, 0.5, 0.0])

    def fg(x):
        t = x - target
        return float(t @ t), 2 * t

    res = native.solve_box(fg, np.zeros(4), -np.ones(4), np.ones(4))
    np.testing.assert_allclose(res.x, [1.0, -1.0, 0.5, 0.0], atol=1e-8)
    assert res.converged
    with pytest.raises(ZeroDivisionError):
        native.solve_box(lambda x: 1 / 0, np.zeros(2), -1.0, 1.0)


def test_native_cross_validates_port_solver():
    """The native L-BFGS, the port's solve_trajectory and scipy's L-BFGS-B
    agree on the integrator objective (tests/test_aux.py): u within 1e-3
    of scipy's and 5e-3 of the port's, the first four at the bound -1."""
    if not native.available():
        pytest.skip('no C++ toolchain')
    from scipy.optimize import minimize
    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout
    from gpmpc_tpu_torch.mpc.controller import single_cost
    from gpmpc_tpu_torch.mpc.cost import CostParams
    from gpmpc_tpu_torch.mpc.solver import solve_trajectory

    rng = np.random.default_rng(0)
    s = rng.uniform(-10, 10, (60, 1))
    a = rng.uniform(-1, 1, (60, 1))
    gp = make_gp(GPConfig(capacity=64, x_dim=2, out_dim=1),
                 np.concatenate([s, a], 1), s + a,
                 log_lambdas=np.log([2.0, 2.0]), log_sigma_f=np.log(3.0),
                 log_sigma_n=np.log(1e-4), dtype=torch.float64, device='cpu')
    cache = build_rollout_cache(gp, 1, 1)
    params = CostParams(Q=2 * torch.eye(1, dtype=torch.float64),
                        R=torch.zeros((1, 1), dtype=torch.float64),
                        gamma=t64(1e-5), x_ref=t64([0.0]), u_ref=t64([0.0]))
    x0 = t64([5.0])

    def obj(u):
        m, c = rollout(cache, x0, u)
        return single_cost(params, m, c, u)

    def fg(u_flat):
        u = t64(u_flat).reshape(5, 1).requires_grad_()
        v = obj(u)
        (g,) = torch.autograd.grad(v, u)
        return float(v.detach()), np_(g).ravel()

    res_native = native.solve_box(fg, np.zeros(5), -np.ones(5), np.ones(5),
                                  max_iters=200, tol=1e-8)
    res_port = solve_trajectory(obj, torch.zeros((5, 1), dtype=torch.float64),
                                -1.0, 1.0, SolverConfig(max_iters=400, tol=1e-6,
                                                        polish_iters=20))
    r = minimize(fg, np.zeros(5), jac=True, method='L-BFGS-B',
                 bounds=[(-1.0, 1.0)] * 5)
    np.testing.assert_allclose(res_native.x, r.x, atol=1e-3)
    np.testing.assert_allclose(np_(res_port.u).ravel(), res_native.x,
                               atol=5e-3)
    np.testing.assert_allclose(res_native.x[:4], -np.ones(4), atol=1e-4)
