"""gpmpc_tpu_torch.mpc.constrained.solve_constrained against gpmpc_tpu's at
f64: hs071 (tests/test_solver_oracle.py:50-98), its known optimum at that
test's bars and the iterate, multipliers and penalty equal to JAX's; the
inner L-BFGS on a flat (4,) u; and a problem with equalities only."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.mpc.constrained import solve_constrained as jsolve
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu_torch.mpc.constrained import solve_constrained
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from torch_port_common import np_, t64

torch.set_num_threads(1)
HS071_X_STAR = np.array([1.00000000, 4.74299963, 3.82114998, 1.37940829])
HS071_F_STAR = 17.0140173


def hs071_objective(x):
    return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]


def hs071_eq_j(x):
    return jnp.array([jnp.sum(x * x) - 40.0])


def hs071_ineq_j(x):
    return jnp.array([x[0] * x[1] * x[2] * x[3] - 25.0])


def hs071_eq(x):
    return (torch.sum(x * x) - 40.0)[None]


def hs071_ineq(x):
    return (x[0] * x[1] * x[2] * x[3] - 25.0)[None]


def _both(outer_iters, cfg):
    res = solve_constrained(hs071_objective, t64([1.0, 5.0, 5.0, 1.0]), 1.0,
                            5.0, eq_con=hs071_eq, ineq_con=hs071_ineq,
                            config=SolverConfig(**cfg),
                            outer_iters=outer_iters)
    jres = jax.jit(lambda u: jsolve(
        hs071_objective, u, 1.0, 5.0, eq_con=hs071_eq_j,
        ineq_con=hs071_ineq_j, config=JSolverConfig(**cfg),
        outer_iters=outer_iters))(jnp.array([1.0, 5.0, 5.0, 1.0], jnp.float64))
    return res, jres


def test_hs071_known_optimum_and_jax():
    """The literature optimum within 1e-5 (x and f) and violations below
    1e-7 (tests/test_solver_oracle.py's bars), on a flat (4,) u; the same
    point as JAX's: x within 1e-6, f within 1e-10 relative. (By the last
    outer iterations both violations sit at the 1e-12 noise floor, where the
    progress test that grows mu compares noise: the packages may end a
    penalty step apart, so the final multipliers and mu are compared in
    test_hs071_outer_iterations_match_jax, before that floor.)"""
    res, jres = _both(15, dict(max_iters=200, tol=1e-10))
    assert res.u.shape == (4,)
    np.testing.assert_allclose(np_(res.u), HS071_X_STAR, atol=1e-5)
    assert abs(float(res.cost) - HS071_F_STAR) < 1e-5
    assert float(res.eq_viol) < 1e-7 and float(res.ineq_viol) < 1e-7
    np.testing.assert_allclose(np_(res.u), np.asarray(jres.u), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=1e-10)


def test_hs071_outer_iterations_match_jax():
    """Three outer iterations, violations well above the noise floor: mu
    equal to JAX's, the iterate within 1e-7 relative and the cost 1e-8
    (measured ~3e-9), the multipliers within 1e-5 (measured 1e-6: they add
    mu c(u), mu = 1e3 here); the violations, differences of terms of 25-40
    whose rounding carries the iterate's ~3e-9 relative difference, within
    1e-6 absolute (measured 7e-9 and 1e-7)."""
    res, jres = _both(3, dict(max_iters=200, tol=1e-10))
    bars = dict(u=(1e-7, 0.0), cost=(1e-8, 0.0), lam_eq=(1e-5, 0.0),
                lam_in=(1e-5, 0.0), mu=(0.0, 0.0), eq_viol=(0.0, 1e-6),
                ineq_viol=(0.0, 1e-6))
    for k, (rtol, atol) in bars.items():
        np.testing.assert_allclose(np_(getattr(res, k)),
                                   np.asarray(getattr(jres, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_equality_only_projection():
    """min |u - (2, 1)|^2 on the unit circle inside the box [-1, 1]^2: the
    radial projection (2, 1) / sqrt(5); no inequality, zero ineq_viol."""
    target = t64([2.0, 1.0])
    res = solve_constrained(lambda u: torch.sum((u - target) ** 2),
                            t64([0.5, 0.5]), -1.0, 1.0,
                            eq_con=lambda u: (torch.sum(u * u) - 1.0)[None],
                            config=SolverConfig(max_iters=100, tol=1e-10))
    np.testing.assert_allclose(np_(res.u), np.array([2.0, 1.0]) / np.sqrt(5),
                               atol=1e-6)
    assert float(res.ineq_viol) == 0.0 and res.lam_in.shape == (0,)
    assert float(res.eq_viol) < 1e-8
