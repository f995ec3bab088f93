"""gpmpc_tpu_torch's plants and analytic pendulum models against
gpmpc_tpu's (the counterparts of tests/test_envs.py): `step` at f64 and f32
for both plants, the env wrappers' f32 stepping returned as f64,
angle_normalize, the nominal/true friction gap, and batch against single."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.envs import cartpole as jcart
from gpmpc_tpu.envs import pendulum as jpend
from gpmpc_tpu.models import pendulum as jmodels
from gpmpc_tpu_torch.envs import cartpole as tcart
from gpmpc_tpu_torch.envs import pendulum as tpend
from gpmpc_tpu_torch.models import pendulum as tmodels
from torch_port_common import np_

torch.set_num_threads(1)
# f64: the same arithmetic; f32: a few ulps of the plant's largest term.
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
       torch.float32: dict(rtol=2e-6, atol=2e-6)}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_pendulum_step_matches_jax(dtype):
    rng = np.random.default_rng(3)
    p = tpend.PendulumParams(g=10.0, max_torque=5.0, max_speed=4.0)
    jp = jpend.PendulumParams(*p)
    s = rng.uniform(-np.pi, np.pi, (40, 2)) * [1.5, 2.0]
    u = rng.uniform(-8, 8, (40, 1))     # beyond the torque limit: the clip
    for i in range(40):
        t_n, t_r = tpend.step(torch.tensor(s[i], dtype=dtype),
                              torch.tensor(u[i], dtype=dtype), p)
        j_n, j_r = jpend.step(jnp.asarray(s[i], JDT[dtype]),
                              jnp.asarray(u[i], JDT[dtype]), jp)
        assert t_n.dtype == dtype
        np.testing.assert_allclose(np_(t_n), np.asarray(j_n), **TOL[dtype])
        np.testing.assert_allclose(float(t_r), float(j_r), **TOL[dtype])
    tb, rb = tpend.step_batch(torch.tensor(s, dtype=dtype),
                              torch.tensor(u, dtype=dtype), p)
    jb, jrb = jpend.step_batch(jnp.asarray(s, JDT[dtype]),
                               jnp.asarray(u, JDT[dtype]), jp)
    np.testing.assert_allclose(np_(tb), np.asarray(jb), **TOL[dtype])
    np.testing.assert_allclose(np_(rb), np.asarray(jrb), **TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_cartpole_step_matches_jax(dtype):
    rng = np.random.default_rng(4)
    p = tcart.CartPoleParams()
    s = rng.uniform(-1, 1, (30, 4))
    a = rng.uniform(-1, 1, (30, 1))
    for i in range(30):
        t_n, t_r = tcart.step(torch.tensor(s[i], dtype=dtype),
                              torch.tensor(a[i], dtype=dtype), p)
        j_n, _ = jcart.step(jnp.asarray(s[i], JDT[dtype]),
                            jnp.asarray(a[i], JDT[dtype]), jcart.CartPoleParams())
        np.testing.assert_allclose(np_(t_n), np.asarray(j_n), **TOL[dtype])
        assert float(t_r) == 1.0
    f = rng.uniform(-30, 30, 30)
    np.testing.assert_allclose(
        np_(tcart.step_physics(torch.tensor(s, dtype=dtype),
                               torch.tensor(f, dtype=dtype), p)),
        np.asarray(jax_batch_physics(s, f, JDT[dtype])), **TOL[dtype])
    tb, _ = tcart.step_batch(torch.tensor(s, dtype=dtype),
                             torch.tensor(a, dtype=dtype), p)
    for i in (0, 17):
        single, _ = tcart.step(torch.tensor(s[i], dtype=dtype),
                               torch.tensor(a[i], dtype=dtype), p)
        np.testing.assert_allclose(np_(tb[i]), np_(single), rtol=0, atol=0)


def jax_batch_physics(s, f, jdt):
    import jax
    return jax.vmap(jcart.step_physics, in_axes=(0, 0, None))(
        jnp.asarray(s, jdt), jnp.asarray(f, jdt), jcart.CartPoleParams())


def test_pendulum_env_steps_in_f32():
    """The wrapper steps the plant in f32 and returns f64: equal to the JAX
    env's states and rewards over an episode of fixed actions."""
    init = {'th_init': 1.0, 'thdot_init': 0.5}
    p = tpend.PendulumParams(g=10.0, max_torque=5.0)
    t_env = tpend.PendulumEnv(params=p, init_state=init, device='cpu')
    j_env = jpend.PendulumEnv(params=jpend.PendulumParams(*p), init_state=init)
    t_obs, _ = t_env.reset()
    j_obs, _ = j_env.reset()
    np.testing.assert_array_equal(t_obs, [1.0, 0.5])
    acts = np.random.default_rng(5).uniform(-6, 6, (12, 1))
    for a in acts:
        t_obs, t_r, term, trunc, _ = t_env.step(a)
        j_obs, j_r, *_ = j_env.step(a)
        assert t_obs.dtype == np.float64 and not term and not trunc
        assert np.all(t_obs == t_obs.astype(np.float32))   # f32 values
        np.testing.assert_allclose(t_obs, j_obs, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(t_r, j_r, rtol=2e-6, atol=2e-6)
    # A random start draws from numpy with the seed, as the JAX env does.
    t_env = tpend.PendulumEnv(seed=7, device='cpu')
    j_env = jpend.PendulumEnv(seed=7)
    np.testing.assert_array_equal(t_env.reset()[0], j_env.reset()[0])


def test_cartpole_env_steps_in_f32():
    t_env = tcart.CartPoleEnv(seed=0, device='cpu')
    j_env = jcart.CartPoleEnv(seed=0)
    t_obs, _ = t_env.reset()
    np.testing.assert_array_equal(t_obs, j_env.reset()[0])
    for a in np.random.default_rng(6).uniform(-1, 1, (10, 1)):
        t_obs, t_r, *_ = t_env.step(a)
        j_obs, j_r, *_ = j_env.step(a)
        assert t_obs.shape == (4,) and t_r == 1.0
        assert np.all(t_obs == t_obs.astype(np.float32))
        np.testing.assert_allclose(t_obs, j_obs, rtol=2e-6, atol=2e-6)


def test_angle_normalize():
    x = np.array([np.pi + 0.1, -np.pi - 0.1, 0.3, 7.0, -12.5, np.pi])
    np.testing.assert_allclose(np_(tpend.angle_normalize(torch.tensor(x))),
                               np.asarray(jpend.angle_normalize(jnp.asarray(x))),
                               atol=1e-12)
    np.testing.assert_allclose(float(tpend.angle_normalize(
        torch.tensor(np.pi + 0.1))), -np.pi + 0.1, atol=1e-12)


def test_sample_transitions_ranges():
    """The port draws from a torch.Generator (JAX's PRNGKey draws cannot be
    reproduced): the ranges, and next states equal to the steppers'."""
    gen = torch.Generator().manual_seed(0)
    p = tpend.PendulumParams(g=10.0, max_torque=5.0)
    s, a, ns = tpend.sample_transitions(gen, 200, p, device='cpu')
    assert s.shape == (200, 2) and a.shape == (200, 1) and ns.shape == (200, 2)
    assert float(s[:, 0].min()) >= 0 and float(s[:, 0].max()) <= np.pi
    assert float(a.abs().max()) <= 5.0 and float(s[:, 1].abs().max()) <= 8.0
    np.testing.assert_array_equal(np_(ns), np_(tpend.step_batch(s, a, p)[0]))
    gen = torch.Generator().manual_seed(1)
    s, a, ns = tcart.sample_transitions(gen, 100, device='cpu')
    assert s.shape == (100, 4) and float(a.abs().max()) <= 1.0
    assert float(s[:, 2].abs().max()) <= np.pi / 4 + 1e-6


def test_models_match_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (5, 2))
    u = rng.uniform(-1, 1, (5,))
    for name in ('nom_model_th', 'nom_model_om', 'true_model_th',
                 'true_model_om'):
        got = getattr(tmodels, name)(torch.tensor(x), torch.tensor(u))
        want = getattr(jmodels, name)(jnp.asarray(x), jnp.asarray(u))
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-12,
                                   err_msg=name)
        for i in range(5):
            np.testing.assert_allclose(
                float(getattr(tmodels, name)(torch.tensor(x[i]),
                                             torch.tensor(u[i]))),
                np_(got)[i], atol=1e-12)
    gap = np_(tmodels.true_model_om(torch.tensor(x), torch.tensor(u))
              - tmodels.nom_model_om(torch.tensor(x), torch.tensor(u)))
    np.testing.assert_allclose(gap, -tmodels.b / tmodels.m * x[:, 1]
                               * tmodels.delta_t, atol=1e-12)
    xu = rng.uniform(-1, 1, (7, 3))
    out = tmodels.nominal_residual_fn(torch.tensor(xu))
    assert out.shape == (7, 2)
    np.testing.assert_allclose(np_(out),
                               np.asarray(jmodels.nominal_residual_fn(
                                   jnp.asarray(xu))), rtol=1e-12)
