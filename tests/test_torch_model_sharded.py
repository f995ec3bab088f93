"""gpmpc_tpu_torch's sharded paths (parallel/mesh, model_sharded, batch's
solve_batch_sharded, distributed) in several CPU processes on gloo, against
gpmpc_tpu and against the port's unsharded path.

The JAX values are computed here, in the pytest process (tests/conftest.py
gives it 8 virtual CPU devices); the ranks run tests/torch_dist_worker.py,
which imports torch and the port only, read their inputs from an npz under
tmp_path and write their results beside it. Each process group has a 60 s
timeout and each launch a 120 s one, so a hang fails rather than stalls.

Bars (f64): the row-sharded variance op summed over 4 ranks against JAX's
`_variance_multi_batched_diag_rows` under shard_map, rtol 1e-10 (the bar of
tests/test_model_sharded.py); its gradient and the (1, 2) value-and-grad
against the unsharded port and JAX, rtol 1e-10 (counting the gradient n_model
times fails this by 100 %); solve_batch_2d on (1, 2) against JAX
solve_batch, u rtol 1e-6 and cost rtol 1e-8 (tests/test_model_sharded.py's
bars); solve_batch_sharded on (2, 1) against the unsharded port, to the bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gpmpc_tpu.dynamics import build_rollout_cache as jcache
from gpmpc_tpu.dynamics import rollout_batched as jrollout
from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.cost import risk_sensitive_cost as jcost
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu.parallel import mesh as jmesh
from gpmpc_tpu.parallel.model_sharded import _variance_multi_batched_diag_rows
from gpmpc_tpu_torch.convert import FIELDS
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig, solve_trajectory_batched
from gpmpc_tpu_torch.ops import moments as tmoments
from gpmpc_tpu_torch.parallel.batch import batch_objective, solve_batch
from gpmpc_tpu_torch.parallel.distributed import launch_ranks
from torch_port_common import np_, port_gp, t64

try:
    from jax import shard_map
except ImportError:                          # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_dist_worker.py')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
B, H, ITERS = 8, 5, 15
RTOL = 1e-10


def _launch(case, world, inputs, tmp):
    """Run `world` ranks of the worker on `inputs` (parallel.distributed's
    launch_ranks, LAUNCH_TIMEOUT_S for all); returns each rank's outputs (a
    list of dicts)."""
    inp = os.path.join(tmp, f'{case}_in.npz')
    prefix = os.path.join(tmp, f'{case}_out')
    np.savez(inp, **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'XLA_FLAGS')}
    env['OMP_NUM_THREADS'] = '1'
    launch_ranks([sys.executable, WORKER, case, inp, prefix], world,
                 LAUNCH_TIMEOUT_S, env=env, cwd=ROOT)
    return [dict(np.load(f'{prefix}_rank{r}.npz')) for r in range(world)]


def _jgp(rng, tied, n=48, cap=64, e=2, d=3):
    """tests/test_model_sharded.py's GP, f64."""
    x = rng.uniform(-2, 2, (n, d))
    y = np.stack([np.sin(x[:, 0]) + 0.3 * x[:, 2], np.cos(x[:, 1])], axis=1)
    ll = np.log([1.5] * d) if tied else np.log(rng.uniform(1.0, 2.0, (e, d)))
    cfg = gs.GPConfig(capacity=cap, x_dim=d, out_dim=e)
    return gs.make_gp(cfg, x, y, log_lambdas=ll, log_sigma_f=np.log(0.8),
                      log_sigma_n=np.log(0.1), dtype=jnp.float64)


def _gp_arrays(prefix, jgp):
    return {f'{prefix}{k}': np.asarray(getattr(jgp, k)) for k in FIELDS}


# --------------------------------------------------------- the rows op --
@pytest.fixture(scope='module')
def rows_run(tmp_path_factory):
    """4 ranks, a (1, 4) mesh: the row-sharded op on a tied and an untied GP,
    beside JAX's op under shard_map on 4 devices."""
    rng = np.random.default_rng(31)
    gps = {'tied': _jgp(rng, True), 'untied': _jgp(rng, False)}
    b, d = 5, 3
    inputs = dict(u=rng.uniform(-1, 1, (b, d)),
                  s_diag=rng.uniform(0.01, 0.1, (b, d)),
                  means=rng.normal(size=(b, 2)) * 0.1,
                  w=rng.uniform(0.5, 1.5, (b, 2)))
    jax_vals = {}
    mesh = jmesh.make_mesh(n_batch=1, n_model=4, devices=jax.devices()[:4])
    for name, jgp in gps.items():
        inputs.update(_gp_arrays(f'{name}_', jgp))
        cache = jcache(jgp, 2, 1)
        n_loc = cache.b_lam.shape[1] // 4

        def local(rows, cache=cache, n_loc=n_loc):
            off = jax.lax.axis_index('model') * n_loc
            return _variance_multi_batched_diag_rows(
                jnp.asarray(inputs['u']), jnp.asarray(inputs['s_diag']),
                cache.x, rows, off, cache.log_lambdas, cache.log_sigma_f,
                jnp.asarray(inputs['means']), 'model',
                tied=cache.tied_lambdas)

        jax_vals[name] = np.asarray(shard_map(
            local, mesh=mesh, in_specs=P(None, 'model', None), out_specs=P(),
            check_vma=False)(cache.b_lam))
    outs = _launch('rows', 4, inputs, str(tmp_path_factory.mktemp('rows')))
    return gps, inputs, jax_vals, outs


@pytest.mark.parametrize('name', ['tied', 'untied'])
def test_rows_op_summed_over_4_ranks_matches_jax_shard_map(rows_run, name):
    _, _, jax_vals, outs = rows_run
    for out in outs:
        np.testing.assert_allclose(out[f'{name}_v'], jax_vals[name],
                                   rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize('name', ['tied', 'untied'])
def test_rows_op_gradient_counts_once(rows_run, name):
    """The gradient of sum(v * w) in (u, s_diag) over 4 ranks equals the
    unsharded op's: the partial cotangents are summed exactly once."""
    gps, inp, _, outs = rows_run
    cache = build_rollout_cache(port_gp(gps[name]), 2, 1)
    u, s = t64(inp['u']).requires_grad_(), t64(inp['s_diag']).requires_grad_()
    v = tmoments.variance_prop_multi_batched_diag(
        u, s, cache.x, cache.b_lam, cache.log_lambdas, cache.log_sigma_f,
        t64(inp['means']), tied=cache.tied_lambdas)
    gu, gsd = torch.autograd.grad(torch.sum(v * t64(inp['w'])), (u, s))
    for out in outs:
        np.testing.assert_allclose(out[f'{name}_gu'], np_(gu), rtol=RTOL,
                                   atol=1e-13)
        np.testing.assert_allclose(out[f'{name}_gs'], np_(gsd), rtol=RTOL,
                                   atol=1e-13)


# ------------------------------------------------------ the model axis --
def _problem(rng):
    """tests/test_model_sharded.py's solve problem: a tied GP, 8 lanes."""
    jgp = _jgp(rng, True)
    gamma = np.linspace(-0.3, 0.3, B)
    x0s = rng.uniform(-1, 1, (B, 2))
    arrays = dict(Q=2.0 * np.eye(2), R=0.01 * np.eye(1), gamma=gamma,
                  x_ref=np.zeros(2), u_ref=np.zeros(1), x0s=x0s,
                  iters=np.int64(ITERS), horizon=np.int64(H),
                  **_gp_arrays('gp_', jgp))
    return jgp, arrays


def _jparams(a):
    return JCostParams(Q=jnp.asarray(a['Q']), R=jnp.asarray(a['R']),
                       gamma=jnp.asarray(a['gamma']),
                       x_ref=jnp.asarray(a['x_ref']),
                       u_ref=jnp.asarray(a['u_ref']))


def _tparams(a):
    return CostParams(Q=t64(a['Q']), R=t64(a['R']), gamma=t64(a['gamma']),
                      x_ref=t64(a['x_ref']), u_ref=t64(a['u_ref']))


def _jax_solve(jgp, a):
    return jbatch.solve_batch(jgp, 2, 1, jnp.asarray(a['x0s']), _jparams(a),
                              H, -1.0, 1.0,
                              JSolverConfig(max_iters=ITERS, tol=1e-6,
                                            history=4))


@pytest.fixture(scope='module')
def model_run(tmp_path_factory):
    """2 ranks, a (1, 2) mesh: the sharded f64 value-and-grad at u_eval and
    solve_batch_2d."""
    rng = np.random.default_rng(7)
    jgp, arrays = _problem(rng)
    arrays['u_eval'] = rng.uniform(-1, 1, (B, H, 1))
    outs = _launch('model', 2, arrays, str(tmp_path_factory.mktemp('model')))
    return jgp, arrays, outs


def test_value_and_grad_1x2_matches_unsharded_and_jax(model_run):
    jgp, a, outs = model_run
    cache = build_rollout_cache(port_gp(jgp), 2, 1)
    u = t64(a['u_eval']).requires_grad_()
    f = batch_objective(cache, t64(a['x0s']), _tparams(a))(u)
    (g,) = torch.autograd.grad(f.sum(), u)

    jc = jcache(jgp, 2, 1)
    jp = _jparams(a)

    def jf(uu):
        means, covs = jrollout(jc, jnp.asarray(a['x0s']), uu)
        return jax.vmap(jcost, in_axes=(jbatch._params_axes(jp), 0, 0, 0))(
            jp, means, covs, uu)

    fj, vjp = jax.vjp(jf, jnp.asarray(a['u_eval']))
    (gj,) = vjp(jnp.ones_like(fj))
    for out in outs:
        assert int(out['n_loc']) == 32
        np.testing.assert_allclose(out['f'], np_(f), rtol=RTOL)
        np.testing.assert_allclose(out['g'], np_(g), rtol=RTOL, atol=1e-13)
        np.testing.assert_allclose(out['f'], np.asarray(fj), rtol=RTOL)
        np.testing.assert_allclose(out['g'], np.asarray(gj), rtol=RTOL,
                                   atol=1e-13)


def test_solve_batch_2d_1x2_matches_jax_solve_batch(model_run):
    jgp, a, outs = model_run
    ref = _jax_solve(jgp, a)
    for out in outs:
        np.testing.assert_allclose(out['u'], np.asarray(ref.u), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(out['cost'], np.asarray(ref.cost),
                                   rtol=1e-8, atol=1e-11)


def test_model_ranks_stay_in_lockstep(model_run):
    """Both ranks of the model group computed the same f, g and solve to
    the bit, so they took the same iterations and met at every
    collective."""
    _, _, (r0, r1) = model_run
    for k in ('f', 'g', 'u', 'cost', 'iters', 'converged'):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


# ------------------------------------------------------ the batch axis --
@pytest.fixture(scope='module')
def batch_run(tmp_path_factory):
    rng = np.random.default_rng(8)
    jgp, arrays = _problem(rng)
    outs = _launch('batch', 2, arrays, str(tmp_path_factory.mktemp('batch')))
    return jgp, arrays, outs


def test_solve_batch_sharded_2x1_matches_unsharded(batch_run):
    """Each rank solves its 4 lanes alone; the gathered result equals the
    unsharded 8-lane solve (lanes are independent and freeze when done)."""
    jgp, a, outs = batch_run
    ref = solve_batch(port_gp(jgp), 2, 1, t64(a['x0s']), _tparams(a), H, -1.0,
                      1.0, SolverConfig(max_iters=ITERS, tol=1e-6, history=4))
    for out in outs:
        np.testing.assert_allclose(out['u'], np_(ref.u), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(out['cost'], np_(ref.cost), rtol=1e-12)
        np.testing.assert_array_equal(out['iters'], np_(ref.iters))


def test_solve_batch_multihost_matches_sharded(batch_run):
    """solve_batch_multihost: each rank contributes its own 4 scenarios and
    gamma lanes; the global result is the sharded one."""
    _, _, outs = batch_run
    for out in outs:
        np.testing.assert_array_equal(out['multi_u'], out['u'])
        np.testing.assert_array_equal(out['multi_cost'], out['cost'])


# ------------------------------------------------ the solver's oracle hook --
def test_val_and_grad_hook_matches_autograd_path():
    """solve_trajectory_batched with an external (f, g) oracle takes the same
    iterates as with autograd of the objective."""
    b, n = 4, 3
    targets = t64(np.random.default_rng(3).uniform(-2, 2, (b, n, 1)))

    def obj(x):
        return torch.sum((x - targets) ** 4 + x ** 2, dim=(1, 2))

    def vg(x):
        return obj(x), 4 * (x - targets) ** 3 + 2 * x

    cfg = SolverConfig(max_iters=30, tol=1e-9)
    u0 = torch.zeros((b, n, 1), dtype=torch.float64)
    ref = solve_trajectory_batched(obj, u0, -1.0, 1.0, cfg)
    hook = solve_trajectory_batched(None, u0, -1.0, 1.0, cfg, val_and_grad=vg)
    np.testing.assert_allclose(np_(hook.u), np_(ref.u), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(np_(hook.iters), np_(ref.iters))


# ------------------------------------------------------- the launcher --
@pytest.mark.parametrize('code, timeout_s, says', [
    ('import sys; sys.exit(3)', 60, 'exit 3'),
    ('print("no marker")', 60, 'exit 0'),
    ('import time; time.sleep(60)', 2, 'timed out after 2 s'),
])
def test_launch_ranks_fails_on_a_bad_rank(code, timeout_s, says):
    """launch_ranks raises with the rank's output when a rank exits non-zero,
    exits without finish_rank's marker, or outlives the timeout (and then
    kills every rank)."""
    with pytest.raises(RuntimeError, match=f'rank 0 of 2 failed.*{says}'):
        launch_ranks([sys.executable, '-c', code], 2, timeout_s)
