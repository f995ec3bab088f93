"""Write gpmpc_tpu_torch/data/headline_ref.npz: the JAX package's f64
objective on the headline problem, the reference values the port is held
against (tests/test_torch_slice.py on the CPU for 8 lanes, chip_smoke.py on
the card for all 256).

The file holds, per lane of the B = 256 headline problem
(benchmarks/problems.py, seed 0):
  u_ref      (256, 20, 1)  the committed f64 reference controls
                           (benchmarks/results/quality_ref_b256.npz)
  j_uref     (256,)        J64(u_ref)
  j_zero     (256,)        J64(0)
  grad_zero  (8, 20, 1)    dJ64/du at u = 0 for lanes 0-7
  j_uref_full     (256,)   J64 at u_ref with the full-covariance rollout
                           (rollout_batched(full_cov=True)); the lanes with
                           gamma below about -0.09 take the cost's PD-cone
                           penalty there (their full covariance grows past
                           1 / (2 |gamma|))
  grad_full_lanes (8,)     FULL_GRAD_LANES, eight lanes of gamma >= 0.03
  grad_uref_full  (8, 20, 1)  dJ64/du of the full-covariance J64 at u_ref
                           for those lanes

J64 is the f64 batched rollout plus the risk-sensitive cost, exactly as
benchmarks/quality.py evaluates it (diagonal covariance unless named full).
Lanes are evaluated in chunks of 32 to keep the CPU's memory small.

Run from the repository root: python tests/make_torch_headline_ref.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'gpmpc_tpu_torch', 'data', 'headline_ref.npz')
CHUNK = 32
N_GRAD = 8
# Lanes of the full-covariance gradient: off the PD-cone penalty, where JAX's
# gradient of the penalised lanes is NaN.
FULL_GRAD_LANES = np.arange(136, 256, 16)


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    from benchmarks.problems import make_headline_problem
    from gpmpc_tpu.dynamics import build_rollout_cache, rollout_batched
    from gpmpc_tpu.mpc.cost import risk_sensitive_cost
    from gpmpc_tpu.parallel.batch import _params_axes

    prob = make_headline_problem(b=256, dtype=jnp.float64)
    u_ref = np.load(os.path.join(ROOT, 'benchmarks', 'results',
                                 'quality_ref_b256.npz'))['u_ref']
    cache = build_rollout_cache(prob.gp, prob.state_dim, prob.action_dim)

    def objective(full_cov):
        @jax.jit
        def j64(x0s, gammas, u):
            params = prob.params._replace(gamma=gammas)
            cost_b = jax.vmap(risk_sensitive_cost,
                              in_axes=(_params_axes(params), 0, 0, 0))
            means, covs = rollout_batched(cache, x0s, u, full_cov=full_cov)
            return cost_b(params, means, covs, u)
        return j64

    def per_lane(j64, u):
        out = []
        for s in range(0, u.shape[0], CHUNK):
            sl = slice(s, s + CHUNK)
            out.append(np.asarray(j64(prob.x0s[sl], prob.params.gamma[sl],
                                      jnp.asarray(u[sl]))))
        return np.concatenate(out)

    def grad(j64, u, lanes):
        return np.asarray(jax.grad(lambda uu: jnp.sum(j64(
            prob.x0s[lanes], prob.params.gamma[lanes], uu)))(
                jnp.asarray(u[lanes])))

    zero = np.zeros_like(u_ref)
    j_diag, j_full = objective(False), objective(True)
    np.savez_compressed(OUT, u_ref=u_ref, j_uref=per_lane(j_diag, u_ref),
                        j_zero=per_lane(j_diag, zero),
                        grad_zero=grad(j_diag, zero, slice(N_GRAD)),
                        j_uref_full=per_lane(j_full, u_ref),
                        grad_full_lanes=FULL_GRAD_LANES,
                        grad_uref_full=grad(j_full, u_ref, FULL_GRAD_LANES))
    print('wrote', OUT)


if __name__ == '__main__':
    main()
