"""The reference against the program at f64 on the CPU at a small N: the
headline objective with one GP shared by the lanes (the program's
batch_objective) and with one GP a lane (its lanes_objective)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import draws
from portbench.reference import objective as ref

CFG = dict(state_dim=2, action_dim=1, n_train=24, capacity=32, lambdas=4.0,
           sigma_f=1.0, sigma_n=0.1, horizon=5, gamma_range=[-0.5, 0.5],
           lb=-5.0, ub=5.0, Q_diag=2.0, R_diag=0.01, init_state_var=1e-3,
           action_var=1e-3, x0_range=[-1.0, 1.0],
           data=dict(state_bound=np.pi, action_bound=5.0, dt=0.05,
                     gravity_gain=15.0, action_gain=3.0))
F64 = torch.float64


def _program_gp(x, ns):
    from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
    return make_gp(GPConfig(capacity=CFG['capacity'], x_dim=3, out_dim=2),
                   x, ns, log_lambdas=np.log([CFG['lambdas']] * 3),
                   log_sigma_f=0.0, log_sigma_n=np.log(0.1), dtype=F64,
                   device='cpu')


def _params(gamma):
    from gpmpc_tpu_torch.mpc.cost import CostParams
    return CostParams(Q=2.0 * torch.eye(2, dtype=F64),
                      R=0.01 * torch.eye(1, dtype=F64), gamma=gamma,
                      x_ref=torch.zeros(2, dtype=F64),
                      u_ref=torch.zeros(1, dtype=F64))


def _inputs(b, seed):
    gen = draws.rng(seed, 9)
    x0 = torch.tensor(gen.uniform(-1, 1, (b, 2)), dtype=F64)
    u = torch.tensor(gen.uniform(-5, 5, (b, CFG['horizon'], 1)), dtype=F64)
    gamma = torch.tensor(draws.gammas(CFG, b), dtype=F64)
    return x0, u, gamma


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_shared_gp_objective_matches_program(seed):
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    x, ns = draws.headline_data(CFG, draws.rng(seed, 0))
    x0, u, gamma = _inputs(16, seed)
    prog = batch_objective(build_rollout_cache(_program_gp(x, ns), 2, 1),
                           x0, _params(gamma))(u)
    gp = ref.fit(torch.tensor(x)[None], torch.tensor(ns)[None],
                 CFG['lambdas'], 1.0, 0.1)
    j = ref.objective(gp, ref.headline(CFG, 'cpu'), x0, u, gamma)
    np.testing.assert_allclose(j.numpy(), prog.numpy(), rtol=1e-9)


@pytest.mark.parametrize('seed', [0, 1])
def test_gp_per_lane_objective_matches_program(seed):
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.parallel.batch import lanes_objective, stack_gps
    b = 4
    data = [draws.headline_data(CFG, draws.rng(seed, 2, i)) for i in range(b)]
    gps = stack_gps([_program_gp(x, ns) for x, ns in data])
    x0, u, gamma = _inputs(b, seed)
    prog = lanes_objective(build_rollout_cache(gps, 2, 1), x0,
                           _params(gamma))(u)
    gp = ref.fit(torch.tensor(np.stack([d[0] for d in data])),
                 torch.tensor(np.stack([d[1] for d in data])),
                 CFG['lambdas'], 1.0, 0.1)
    j = ref.objective(gp, ref.headline(CFG, 'cpu'), x0, u, gamma)
    np.testing.assert_allclose(j.numpy(), prog.numpy(), rtol=1e-9)


def test_judge_residual_is_zero_at_a_box_corner():
    """Controls at a bound whose gradient pushes outward read 0: the
    projected-gradient residual of the solver's convergence test."""
    x, ns = draws.headline_data(CFG, draws.rng(0, 0))
    gp = ref.fit(torch.tensor(x)[None], torch.tensor(ns)[None], 4.0, 1.0,
                 0.1)
    h = ref.headline(CFG, 'cpu')
    x0, u, gamma = _inputs(3, 0)
    j, pg = ref.judge(gp, h, x0, u, gamma)
    assert torch.isfinite(j).all() and (pg > 0).all()
    _, pg_far = ref.judge(gp, h, x0, torch.full_like(u, 1e3), gamma)
    assert (pg_far > 100).all()


EP = dict(CFG, lambdas=2.0, sigma_n=0.01, horizon=4, gamma_range=[0.0, 0.0],
          delta_dynamics=True)


@pytest.mark.parametrize('seed', [0, 1])
def test_delta_gp_per_lane_objective_matches_program(seed):
    """The episode's objective: delta dynamics (the state plus the GP's
    increment, with the input-output covariance), one GP a lane, the
    multistart recipe's batch_objective over a stacked GP."""
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
    from gpmpc_tpu_torch.parallel.batch import batch_objective, stack_gps
    b = 4
    data = [draws.headline_data(CFG, draws.rng(seed, 5, i)) for i in range(b)]
    data = [(x, ns - x[:, :2]) for x, ns in data]
    gps = stack_gps([make_gp(GPConfig(capacity=32, x_dim=3, out_dim=2), x, y,
                             log_lambdas=np.log([2.0] * 3), log_sigma_f=0.0,
                             log_sigma_n=np.log(0.01), dtype=F64,
                             device='cpu') for x, y in data])
    x0, u, _ = _inputs(b, seed)
    gamma = torch.zeros(b, dtype=F64)
    prog = batch_objective(build_rollout_cache(gps, 2, 1), x0,
                           _params(torch.tensor(0.0, dtype=F64)),
                           delta=True)(u)
    gp = ref.fit(torch.tensor(np.stack([d[0] for d in data])),
                 torch.tensor(np.stack([d[1] for d in data])), 2.0, 1.0, 0.01)
    j = ref.objective(gp, ref.headline(EP, 'cpu'), x0, u, gamma)
    np.testing.assert_allclose(j.numpy(), prog.numpy(), rtol=1e-8)


def test_plant_matches_program():
    from gpmpc_tpu_torch.envs import pendulum
    from portbench.reference import pendulum as ref_plant
    plant = dict(g=10.0, m=1.0, l=1.0, dt=0.05, max_speed=8.0,
                 max_torque=5.0)
    gen = draws.rng(3, 6)
    x = torch.tensor(gen.uniform(-4, 4, (64, 2)), dtype=F64)
    u = torch.tensor(gen.uniform(-7, 7, (64, 1)), dtype=F64)
    prog, _ = pendulum.step_batch(x, u, pendulum.PendulumParams(**plant))
    np.testing.assert_allclose(ref_plant.step(plant, x, u).numpy(),
                               prog.numpy(), rtol=1e-14, atol=1e-14)


def test_pretrain_draw_matches_program():
    """The frozen pretrain draw gives the program's own sample_transitions
    bits on the CPU."""
    from gpmpc_tpu_torch.envs import pendulum
    cfg = dict(n_pretrain=50, data_seed=0,
               plant=dict(g=10.0, m=1.0, l=1.0, dt=0.05, max_speed=8.0,
                          max_torque=5.0))
    s, a, ns = draws.pendulum_pretrain(cfg, torch.device('cpu'))
    gen = torch.Generator(device='cpu')
    gen.manual_seed(0)
    ps, pa, pns = pendulum.sample_transitions(
        gen, 50, pendulum.PendulumParams(g=10.0, max_torque=5.0),
        dtype=torch.float32, device='cpu')
    for mine, theirs in ((s, ps), (a, pa), (ns, pns)):
        assert torch.equal(mine, theirs)


def test_fit_adds_jitter_only_where_needed():
    """A lane whose K is singular (duplicate points, no noise) is fitted
    with jitter; a sound lane beside it exactly, without."""
    x, ns = draws.headline_data(CFG, draws.rng(0, 0))
    dup = np.concatenate([x[:12], x[:12]])
    xs = torch.tensor(np.stack([x, dup]))
    ys = torch.tensor(np.stack([ns, np.concatenate([ns[:12], ns[:12]])]))
    gp = ref.fit(xs, ys, 4.0, 1.0, 0.0)
    assert torch.isfinite(gp.beta).all() and torch.isfinite(gp.kinv).all()
    k = torch.exp(-0.5 * ((xs[0][:, None] - xs[0][None]) ** 2 / 4.0)
                  .sum(-1))
    np.testing.assert_allclose(gp.kinv[0, 0].numpy(),
                               torch.linalg.inv(k).numpy(), rtol=1e-6)
