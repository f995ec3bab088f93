"""gpmpc_tpu_torch.sim.simulator against gpmpc_tpu's at f64 (the
counterparts of tests/test_sim.py): the host Simulator over three steps on
shared data (states, actions, costs and the GP count equal to JAX's),
learn_online=False, the renderer that is not ported, and
run_episode_on_device's carry, shapes, count and trajectory."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.envs import pendulum as jpend
from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.mpc.controller import RiskSensitiveMPC as JMPC
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.solver import SolverConfig as JConfig
from gpmpc_tpu.sim.simulator import Simulator as JSim
from gpmpc_tpu.sim.simulator import run_episode_on_device as j_run
from gpmpc_tpu_torch.envs import pendulum as tpend
from gpmpc_tpu_torch.gp import state as ts
from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC as TMPC
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.sim.simulator import Simulator, run_episode_on_device
from torch_port_common import np_

torch.set_num_threads(1)
# The plants step in f32 (both env wrappers), so the states agree to a few
# f32 ulps; the actions carry that and the trace's ~1e-9 (see
# test_torch_controller.py).
RTOL, ATOL = 1e-5, 1e-6


def _transitions(n, seed, max_torque):
    """Pendulum transitions drawn with numpy, stepped by the f64 plant."""
    rng = np.random.default_rng(seed)
    s = np.stack([rng.uniform(0, np.pi, n), rng.uniform(-8, 8, n)], axis=1)
    a = rng.uniform(-max_torque, max_torque, (n, 1))
    p = tpend.PendulumParams(max_torque=max_torque)
    ns = np_(tpend.step_batch(torch.tensor(s), torch.tensor(a), p)[0])
    return s, a, ns


def test_simulator_matches_jax():
    p = tpend.PendulumParams(g=10.0, max_torque=3.0)
    init = {'th_init': 0.5, 'thdot_init': 0.0}
    args = dict(gamma=0.0, horizon=3, state_dim=2, input_dim=1,
                Q=2 * np.eye(2), R=0.1 * np.eye(1), R_delta=0.01 * np.eye(1),
                capacity=48, delta_dynamics=True)
    cfg = dict(max_iters=30, tol=1e-4)
    j = JMPC(dtype=jnp.float64, solver=JConfig(**cfg), **args)
    t = TMPC(dtype=torch.float64, solver=SolverConfig(**cfg), device='cpu',
             **args)
    s, a, ns = _transitions(30, 1, 3.0)
    for mpc in (j, t):
        mpc.set_ub([3.0])
        mpc.set_lb([-3.0])
        mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_n=0.05)
        mpc.dynamics.append_train_data(s, a, ns)
    jlog = JSim(j, jpend.PendulumEnv(jpend.PendulumParams(*p), init_state=init),
                num_iters=3).run()
    tlog = Simulator(t, tpend.PendulumEnv(p, init_state=init, device='cpu'),
                     num_iters=3).run()
    assert tlog.states.shape == (4, 2) and tlog.actions.shape == (3, 1)
    assert tlog.solve_times.shape == (3,) and np.all(tlog.solve_times > 0)
    np.testing.assert_allclose(tlog.actions, jlog.actions, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlog.states, jlog.states, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlog.rewards, jlog.rewards, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlog.costs, jlog.costs, rtol=RTOL)
    np.testing.assert_array_equal(tlog.iters, jlog.iters)
    assert int(t.gp.count) == int(j.gp.count) == 33
    np.testing.assert_allclose(np_(t.gp.x[:33]), np.asarray(j.gp.x[:33]),
                               rtol=RTOL, atol=ATOL)


def test_online_learning_from_empty():
    """From an empty GP: zero action first, one append a step, actions in
    the bounds (tests/test_sim.py's host loop)."""
    env = tpend.PendulumEnv(tpend.PendulumParams(max_torque=2.0), device='cpu',
                            init_state={'th_init': 0.5, 'thdot_init': 0.0})
    mpc = TMPC(gamma=0.0, horizon=3, state_dim=2, input_dim=1,
               Q=2 * np.eye(2), R=0.1 * np.eye(1), capacity=32,
               delta_dynamics=True, dtype=torch.float64, device='cpu',
               solver=SolverConfig(max_iters=30))
    mpc.set_ub([2.0])
    mpc.set_lb([-2.0])
    log = Simulator(mpc, env, num_iters=5).run()
    assert log.states.shape == (6, 2) and log.actions.shape == (5, 1)
    assert int(mpc.gp.count) == 5
    assert np.all(np.abs(log.actions) <= 2.0 + 1e-9)
    np.testing.assert_allclose(log.actions[0], 0.0)
    assert np.isnan(log.costs[0]) and log.iters[0] == 0


def test_learn_online_off_and_renderer(tmp_path):
    """learn_online=False keeps the GP empty; a renderer records one frame
    a step and the last state, and the episode is written as a GIF."""
    from gpmpc_tpu_torch.sim.render import pendulum_renderer
    env = tpend.PendulumEnv(device='cpu',
                            init_state={'th_init': 0.5, 'thdot_init': 0.0})
    mpc = TMPC(gamma=0.0, horizon=3, state_dim=2, input_dim=1, Q=np.eye(2),
               R=np.eye(1), capacity=16, dtype=torch.float64, device='cpu')
    Simulator(mpc, env, num_iters=3, learn_online=False).run()
    assert int(mpc.gp.count) == 0
    path = tmp_path / 'ep.gif'
    sim = Simulator(mpc, env, num_iters=3, learn_online=False,
                    renderer=pendulum_renderer(size=64), video_path=str(path))
    log = sim.run()
    frames = sim.recorder.frames
    assert len(frames) == len(log.actions) + 1 == 4
    assert frames[0].shape == (64, 64, 3) and frames[0].dtype == np.uint8
    assert path.stat().st_size > 200


def _episode_gp(n, cap, seed):
    s, a, ns = _transitions(n, seed, 3.0)
    x, d = np.concatenate([s, a], axis=1), ns - s
    hp = dict(log_lambdas=np.log(np.full((2, 3), 3.0)),
              log_sigma_n=np.log(np.full(2, 0.05)))
    return (gs.make_gp(gs.GPConfig(capacity=cap, x_dim=3, out_dim=2), x, d,
                       dtype=jnp.float64, **hp),
            ts.make_gp(ts.GPConfig(capacity=cap, x_dim=3, out_dim=2), x, d,
                       dtype=torch.float64, device='cpu', **hp))


def test_run_episode_on_device_matches_jax():
    """Four steps of the on-device episode (the f64 plant as a torch
    function, the single-scenario solve, the append in the loop): shapes,
    count 20 + 4, actions within the bounds, and JAX's trajectory."""
    p = tpend.PendulumParams(max_torque=3.0)
    jgp, tgp = _episode_gp(20, 32, 0)
    leaves = dict(Q=2 * np.eye(2), R=0.1 * np.eye(1), gamma=np.array(0.0),
                  x_ref=np.zeros(2), u_ref=np.zeros(1),
                  R_delta=0.01 * np.eye(1))
    jp = JCostParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tp = CostParams(**{k: torch.tensor(v) for k, v in leaves.items()})
    kw = dict(horizon=3, num_steps=4, lb=-3.0, ub=3.0, delta_dynamics=True)
    jgp_f, jouts = jax.jit(lambda g, x0: j_run(
        g, lambda s, u: jpend.step(s, u, jpend.PendulumParams(*p)), x0, jp,
        solver=JConfig(max_iters=25), **kw))(jgp, jnp.asarray([0.5, 0.0]))
    tgp_f, touts = run_episode_on_device(
        tgp, lambda s, u: tpend.step(s, u, p), torch.tensor([0.5, 0.0],
                                                           dtype=torch.float64),
        tp, solver=SolverConfig(max_iters=25), **kw)
    assert touts['state'].shape == (4, 2) and touts['action'].shape == (4, 1)
    assert bool(torch.isfinite(touts['state']).all())
    assert int(tgp_f.count) == 24 and tgp_f.x.device == tgp.x.device
    assert float(touts['action'].abs().max()) <= 3.0 + 1e-9
    for k in ('state', 'action', 'reward', 'cost'):
        np.testing.assert_allclose(np_(touts[k]), np.asarray(jouts[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(np_(touts['iters']), np.asarray(jouts['iters']))
    np.testing.assert_allclose(np_(tgp_f.beta), np.asarray(jgp_f.beta),
                               rtol=RTOL, atol=ATOL)


def test_run_episode_on_device_multistart_off_and_learning_off():
    """learn_online=False keeps the GP; multistart with full_cov falls back
    to the single solve, as in JAX."""
    p = tpend.PendulumParams(max_torque=3.0)
    _, tgp = _episode_gp(16, 24, 1)
    tp = CostParams(Q=2 * torch.eye(2, dtype=torch.float64),
                    R=0.1 * torch.eye(1, dtype=torch.float64),
                    gamma=torch.tensor(0.0, dtype=torch.float64),
                    x_ref=torch.zeros(2, dtype=torch.float64),
                    u_ref=torch.zeros(1, dtype=torch.float64))
    gp_f, outs = run_episode_on_device(
        tgp, lambda s, u: tpend.step(s, u, p),
        torch.tensor([0.3, 0.1], dtype=torch.float64), tp, horizon=3,
        num_steps=2, lb=-3.0, ub=3.0, solver=SolverConfig(max_iters=15),
        learn_online=False, delta_dynamics=True, solver_recipe='multistart',
        full_cov=True)
    assert gp_f is tgp and outs['state'].shape == (2, 2)
    assert bool(torch.isfinite(outs['cost']).all())
