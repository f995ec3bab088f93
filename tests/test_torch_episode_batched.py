"""The batched on-device episode, gpmpc_tpu_torch's run_episode_on_device
given x0 of shape (B, ds), against JAX's jax.jit(jax.vmap(...)) of
gpmpc_tpu's at f64 (tests/test_sim.py's batched settings: capacity 24, 16
pretrain transitions, 3 x0s, H = 3, 3 steps, max_iters=20): the 'single'
route and the 'multistart' route at n_starts=1 (no random draws on either
side) against JAX, n_starts=4 against the port's own one-x0 episodes lane by
lane (the start draws cannot match jax.random; every lane draws the starts
of one lane, as under JAX's vmap), and the final GP stacked over the
lanes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.envs import pendulum as jpend
from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.solver import SolverConfig as JConfig
from gpmpc_tpu.sim.simulator import run_episode_on_device as j_run
from gpmpc_tpu_torch.envs import pendulum as tpend
from gpmpc_tpu_torch.gp import state as ts
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.sim.simulator import run_episode_on_device
from torch_port_common import np_

torch.set_num_threads(2)
# test_torch_sim.py's bars: the plants step in f64 here, the solves agree to
# the trace's ~1e-9.
RTOL, ATOL = 1e-5, 1e-6
B, H, T, CAP = 3, 3, 3, 24
PLANT = tpend.PendulumParams(max_torque=3.0)
LEAVES = dict(Q=2 * np.eye(2), R=0.1 * np.eye(1), gamma=np.array(0.0),
              x_ref=np.zeros(2), u_ref=np.zeros(1), R_delta=0.01 * np.eye(1))
KW = dict(horizon=H, num_steps=T, lb=-3.0, ub=3.0, delta_dynamics=True)
FIELDS = ('state', 'action', 'reward', 'cost')


def _gps():
    """The pretrained GP on both sides: 16 transitions drawn with numpy,
    stepped by the f64 plant."""
    rng = np.random.default_rng(1)
    s = np.stack([rng.uniform(0, np.pi, 16), rng.uniform(-8, 8, 16)], axis=1)
    a = rng.uniform(-3.0, 3.0, (16, 1))
    ns = np_(tpend.step_batch(torch.tensor(s), torch.tensor(a), PLANT)[0])
    x, d = np.concatenate([s, a], axis=1), ns - s
    hp = dict(log_lambdas=np.log(np.full((2, 3), 3.0)),
              log_sigma_n=np.log(np.full(2, 0.05)))
    return (gs.make_gp(gs.GPConfig(capacity=CAP, x_dim=3, out_dim=2), x, d,
                       dtype=jnp.float64, **hp),
            ts.make_gp(ts.GPConfig(capacity=CAP, x_dim=3, out_dim=2), x, d,
                       dtype=torch.float64, device='cpu', **hp))


X0S = np.random.default_rng(0).uniform(-0.5, 0.5, (B, 2))


def _jax(jgp, **kw):
    jp = JCostParams(**{k: jnp.asarray(v) for k, v in LEAVES.items()})
    cfg = JConfig(max_iters=20)

    def one(x0):
        return j_run(jgp, lambda s, u: jpend.step(
            s, u, jpend.PendulumParams(*PLANT)), x0, jp, solver=cfg, **KW,
            **kw)

    return jax.jit(jax.vmap(one))(jnp.asarray(X0S))


def _port(tgp, x0s, **kw):
    tp = CostParams(**{k: torch.tensor(v) for k, v in LEAVES.items()})
    return run_episode_on_device(
        tgp, lambda s, u: tpend.step(s, u, PLANT), torch.tensor(x0s), tp,
        solver=SolverConfig(max_iters=20), **KW, **kw)


@pytest.fixture(scope='module')
def single():
    jgp, tgp = _gps()
    return _jax(jgp), _port(tgp, X0S)


def _assert_outs(touts, jouts):
    for k in FIELDS:
        assert tuple(touts[k].shape[:2]) == (B, T), k
        np.testing.assert_allclose(np_(touts[k]), np.asarray(jouts[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(np_(touts['iters']),
                                  np.asarray(jouts['iters']))


def test_single_route_matches_jax_vmap(single):
    (_, jouts), (_, touts) = single
    assert touts['state'].shape == (B, T, 2) and touts['action'].shape == (
        B, T, 1)
    assert float(touts['action'].abs().max()) <= 3.0 + 1e-9
    _assert_outs(touts, jouts)


def test_final_gp_stacked_per_lane(single):
    """The final GP carries every lane's own data: count 16 + T a lane,
    the lanes' appended rows apart, x and beta equal to JAX's vmap."""
    (jgp_f, _), (tgp_f, touts) = single
    assert tgp_f.x.shape == (B, CAP, 3) and tgp_f.beta.shape == (B, 2, CAP)
    np.testing.assert_array_equal(np_(tgp_f.count), [16 + T] * B)
    np.testing.assert_array_equal(np_(tgp_f.count), np.asarray(jgp_f.count))
    new = np_(tgp_f.x[:, 16:16 + T])
    assert not np.allclose(new[0], new[1])
    np.testing.assert_array_equal(new[:, :, :2], np.concatenate(
        [X0S[:, None], np_(touts['state'][:, :-1])], axis=1))
    np.testing.assert_allclose(np_(tgp_f.x), np.asarray(jgp_f.x),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(tgp_f.beta), np.asarray(jgp_f.beta),
                               rtol=RTOL, atol=ATOL)


def test_multistart_one_start_matches_jax_vmap():
    """n_starts=1: the cold start and the warm one, no draws on either
    side; each lane's candidates against its own GP (K1's grouped form on
    the card, its plain version here)."""
    jgp, tgp = _gps()
    _, jouts = _jax(jgp, solver_recipe='multistart', n_starts=1)
    tgp_f, touts = _port(tgp, X0S, solver_recipe='multistart', n_starts=1)
    _assert_outs(touts, jouts)
    np.testing.assert_array_equal(np_(tgp_f.count), [16 + T] * B)


def test_multistart_four_starts_matches_one_x0_episodes():
    """n_starts=4 batched against the port's own one-x0 episodes, lane by
    lane: the same draws for every lane (those of a one-lane call), so each
    lane is its own episode to the bit."""
    _, tgp = _gps()
    kw = dict(solver_recipe='multistart', n_starts=4)
    tgp_f, touts = _port(tgp, X0S, **kw)
    for b in range(B):
        g1, o1 = _port(tgp, X0S[b], **kw)
        for k in (*FIELDS, 'iters'):
            torch.testing.assert_close(touts[k][b], o1[k], rtol=0, atol=0,
                                       msg=f'lane {b} {k}')
        for k in ('x', 'beta', 'kinv', 'count'):
            torch.testing.assert_close(getattr(tgp_f, k)[b], getattr(g1, k),
                                       rtol=0, atol=0)


def test_stacked_cache_keeps_slab_at_storage_width():
    """A stacked f32 GP's cache out of batch._setup keeps b_lam in f32 (no
    f64 copy), and the multistart route's objective over it (lane-major
    candidates, the trace's vmap rule: K1's grouped form, its plain version
    here) and its gradient equal, to the bit, those over the cache with
    b_lam widened to f64, the route of a cache that held a widened copy."""
    import dataclasses
    from gpmpc_tpu_torch.parallel import batch
    rng = np.random.default_rng(7)
    hp = dict(log_lambdas=np.log(np.full((2, 3), 3.0)),
              log_sigma_n=np.log(np.full(2, 0.05)))
    gps = [ts.make_gp(ts.GPConfig(capacity=CAP, x_dim=3, out_dim=2),
                      rng.uniform(-1, 1, (12, 3)), rng.normal(size=(12, 2)),
                      dtype=torch.float32, device='cpu', **hp)
           for _ in range(B)]
    x0s = torch.tensor(X0S, dtype=torch.float32)
    cache = batch._setup(batch.stack_gps(gps), x0s, 2, 1)
    assert cache.b_lam.dtype == torch.float32 and cache.b_lam.shape == (
        B, 2, CAP, CAP)
    k = 5
    tp = CostParams(**{n: torch.tensor(v, dtype=torch.float32)
                       for n, v in LEAVES.items() if n != 'R_delta'})
    u = torch.tensor(rng.uniform(-1, 1, (B * k, H, 1)), dtype=torch.float32)
    res = []
    for c in (cache, dataclasses.replace(cache, b_lam=cache.b_lam.double())):
        obj = batch.batch_objective(c, x0s.repeat_interleave(k, 0), tp,
                                    delta=True)
        uu = u.clone().requires_grad_()
        j = obj.build(*obj.inputs)(uu)
        res.append((j, torch.autograd.grad(j.sum(), uu)[0]))
    (j32, g32), (j64, g64) = res
    assert torch.isfinite(j32).all()
    assert torch.equal(j32, j64) and torch.equal(g32, g64)
