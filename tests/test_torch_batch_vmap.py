"""gpmpc_tpu_torch.parallel.batch.solve_batch(impl='vmap') against
gpmpc_tpu's at f64: each lane solved on its own with the single-scenario
rollout, by projected Adam and by L-BFGS, u, cost and iters lane for lane at
tests/test_batched.py's solve tolerance (rtol 1e-8, atol 1e-10); and the
route guards ('fused' with Adam raises ValueError, as JAX's). The route
choice of impl='auto' is tests/test_torch_solver.py's
test_solve_batch_auto_route_matches_jax."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.problems import make_headline_problem as jmake
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel.batch import solve_batch
from gpmpc_tpu_torch.problems import make_headline_problem as tmake
from torch_port_common import assert_same_solve, jit_solve, np_

torch.set_num_threads(1)
SMALL = dict(b=3, seed=1, n_train=24, capacity=32, horizon=4)
ADAM = dict(method='adam', max_iters=25, tol=1e-3, learning_rate=0.05,
            polish_iters=5)


def _problems():
    return (jmake(dtype=jnp.float64, **SMALL),
            tmake(dtype=torch.float64, device='cpu', **SMALL))


def _jax_vmap(jp, cfg):
    return jit_solve(lambda x0s, p: jbatch.solve_batch(
        jp.gp, 2, 1, x0s, p, jp.horizon, jp.lb, jp.ub, JSolverConfig(**cfg),
        impl='vmap'), jp.x0s, jp.params)


def test_vmap_adam_matches_jax():
    """Each lane's own projected Adam and polish; the lockstep L-BFGS at the
    same budget gives other controls."""
    jp, tp = _problems()
    tres = solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb,
                       tp.ub, SolverConfig(**ADAM), impl='vmap')
    assert_same_solve(tres, _jax_vmap(jp, ADAM))
    lockstep = solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb,
                           tp.ub, SolverConfig(max_iters=25, tol=1e-3))
    assert not np.allclose(np_(lockstep.u), np_(tres.u), atol=1e-6)


def test_vmap_lbfgs_matches_jax_and_fused():
    """Each lane's own line search, history and stop, equal to JAX's vmap
    lane for lane and to the fused route's controls."""
    jp, tp = _problems()
    cfg = dict(max_iters=30, tol=1e-6)
    tres = solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb,
                       tp.ub, SolverConfig(**cfg), impl='vmap')
    assert_same_solve(tres, _jax_vmap(jp, cfg))
    fused = solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb,
                        tp.ub, SolverConfig(**cfg), impl='fused')
    np.testing.assert_allclose(np_(fused.u), np_(tres.u), rtol=1e-6,
                               atol=1e-8)


def test_route_guards():
    _, tp = _problems()
    with pytest.raises(ValueError, match='fused'):
        solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb, tp.ub,
                    SolverConfig(method='adam'), impl='fused')
    with pytest.raises(ValueError, match='unknown impl'):
        solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb, tp.ub,
                    impl='lockstep')
