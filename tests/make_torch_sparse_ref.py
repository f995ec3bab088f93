"""Write gpmpc_tpu_torch/data/sparse_ref.npz: the JAX package's f64 values on
the paths of chip_smoke.py's phase 8, the reference the port is held against
there (on the card) and in tests/test_torch_sparse_ref.py (on the CPU).

Configurations: the suite's sparse workloads of benchmarks/problems.py
(config 3b, make_sparse_cartpole_problem(b=256); config 4,
make_sparse_fullcov_problem(b=64)) in f64, with their committed f64
reference controls benchmarks/results/quality_sparse_ref_<name>.npz; the
headline problem (make_headline_problem(b=256), f64) for the per-scenario
routes; experiments/uncertainty.py at its published settings.

The file holds, for <w> in (3b, 4):
  <w>_w, <w>_alpha     (E, M, M) (E, M)  the f64 FITC posterior (kinv, beta)
  <w>_j_uref           (B,)         J64 at u_ref (config 4: full covariance)
  <w>_grad_uref        (B, H, 1)    dJ64/du at u_ref, every lane
  <w>_j_zero, <w>_grad_zero         J64 and dJ64/du at u = 0
and
  adam_lanes           (2,)         headline lanes of the Adam route
  adam_u, adam_cost, adam_iters, adam_pg_norm   solve_batch(impl='auto')
                       with ADAM on those lanes ('auto' -> 'vmap')
  gp_seeds             (3,)         headline data seeds of the GP draws
  gp_u, gp_cost, gp_iters, gp_pg_norm   solve_batch_gp over stack_gps of
                       those draws, gammas GP_GAMMAS, GP_SOLVER
  unc_gammas           (2,)         the uncertainty experiment's gammas
  unc_u (2, 6, 2), unc_expected (2, 7, 2), unc_covs (2, 7, 2, 2)
                       its controls, GP means and covariances, and
  unc_iters            (2,)         its solver iterations
  configs              JSON: ADAM, GP_SOLVER and GP_GAMMAS

Run from the repository root: python tests/make_torch_sparse_ref.py (JAX on
the CPU, ~3 min).
"""

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'gpmpc_tpu_torch', 'data', 'sparse_ref.npz')
WORKLOADS = (('3b', '3b_sparse_cartpole', 'make_sparse_cartpole_problem', 256,
              False),
             ('4', '4_sparse_fullcov', 'make_sparse_fullcov_problem', 64,
              True))
ADAM_LANES = np.array([0, 255])
ADAM = dict(method='adam', max_iters=30, tol=1e-4, learning_rate=0.05,
            polish_iters=5)
GP_SEEDS = np.array([0, 1, 2])
GP_GAMMAS = np.array([-0.3, 0.0, 0.3])
GP_SOLVER = dict(max_iters=12, tol=1e-4)


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    import benchmarks.problems as problems
    from gpmpc_tpu.dynamics import build_rollout_cache, rollout_batched
    from gpmpc_tpu.experiments import uncertainty
    from gpmpc_tpu.mpc.cost import risk_sensitive_cost
    from gpmpc_tpu.mpc.solver import SolverConfig
    from gpmpc_tpu.parallel import batch as pbatch

    out = {}
    for tag, name, maker, b, full_cov in WORKLOADS:
        p = getattr(problems, maker)(b=b, dtype=jnp.float64)
        cache = build_rollout_cache(p.gp, p.state_dim, p.action_dim)
        cost_b = jax.vmap(risk_sensitive_cost,
                          in_axes=(pbatch._params_axes(p.params), 0, 0, 0))

        def total(u, p=p, cache=cache, cost_b=cost_b, full_cov=full_cov):
            means, covs = rollout_batched(cache, p.x0s, u, full_cov=full_cov)
            j = cost_b(p.params, means, covs, u)
            return jnp.sum(j), j

        u_ref = np.load(os.path.join(ROOT, 'benchmarks', 'results',
                                     f'quality_sparse_ref_{name}.npz'))['u_ref']
        vg = jax.jit(jax.value_and_grad(total, has_aux=True))
        (_, j), g = vg(jnp.asarray(u_ref))
        (_, j0), g0 = vg(jnp.zeros_like(jnp.asarray(u_ref)))
        out.update({f'{tag}_w': np.asarray(p.gp.kinv),
                    f'{tag}_alpha': np.asarray(p.gp.beta),
                    f'{tag}_j_uref': np.asarray(j),
                    f'{tag}_grad_uref': np.asarray(g),
                    f'{tag}_j_zero': np.asarray(j0),
                    f'{tag}_grad_zero': np.asarray(g0)})
        print(tag, 'J64(u_ref) mean', float(np.mean(j)), flush=True)

    hp = problems.make_headline_problem(b=256, dtype=jnp.float64)
    params = hp.params._replace(gamma=hp.params.gamma[ADAM_LANES])
    res = jax.jit(lambda x0s, prm: pbatch.solve_batch(
        hp.gp, 2, 1, x0s, prm, hp.horizon, hp.lb, hp.ub,
        SolverConfig(**ADAM)))(hp.x0s[ADAM_LANES], params)
    out.update(adam_lanes=ADAM_LANES, adam_u=np.asarray(res.u),
               adam_cost=np.asarray(res.cost), adam_iters=np.asarray(res.iters),
               adam_pg_norm=np.asarray(res.pg_norm))
    print('adam iters', np.asarray(res.iters), flush=True)

    gps = pbatch.stack_gps([problems.make_headline_problem(
        b=1, dtype=jnp.float64, seed=int(s)).gp for s in GP_SEEDS])
    res = jax.jit(lambda g, x0s, prm: pbatch.solve_batch_gp(
        g, 2, 1, x0s, prm, hp.horizon, hp.lb, hp.ub,
        SolverConfig(**GP_SOLVER)))(
        gps, hp.x0s[:len(GP_SEEDS)],
        hp.params._replace(gamma=jnp.asarray(GP_GAMMAS)))
    out.update(gp_seeds=GP_SEEDS, gp_u=np.asarray(res.u),
               gp_cost=np.asarray(res.cost), gp_iters=np.asarray(res.iters),
               gp_pg_norm=np.asarray(res.pg_norm))
    print('gp draws iters', np.asarray(res.iters), flush=True)

    gammas = (-1.0, 1e-5)
    with tempfile.TemporaryDirectory() as d:
        unc = uncertainty.uncertainty_experiment(gammas=gammas, out_dir=d,
                                                 verbose=False)
    out.update(unc_gammas=np.array(gammas),
               unc_u=np.stack([unc[g]['u'] for g in gammas]),
               unc_expected=np.stack([unc[g]['expected'] for g in gammas]),
               unc_covs=np.stack([unc[g]['covs'] for g in gammas]))
    iters = []
    for g in gammas:
        mpc = _uncertainty_controller(g)
        mpc.get_optimal_trajectory(np.array([4.0, -4.0]))
        iters.append(int(mpc.last_result.iters))
    out['unc_iters'] = np.array(iters)
    out['configs'] = json.dumps(dict(adam=ADAM, gp_solver=GP_SOLVER,
                                     gp_gammas=GP_GAMMAS.tolist()))
    print('uncertainty iters', iters, flush=True)

    np.savez_compressed(OUT, **out)
    print('wrote', OUT, {k: np.shape(v) for k, v in out.items()})


def _uncertainty_controller(gamma):
    """experiments/uncertainty.py's controller (its iterations are not in
    the experiment's result)."""
    import jax.numpy as jnp

    from gpmpc_tpu.experiments.uncertainty import make_l_shaped_data
    from gpmpc_tpu.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu.mpc.solver import SolverConfig
    states, actions, next_states = make_l_shaped_data(0)
    mpc = RiskSensitiveMPC(gamma=gamma, horizon=6, state_dim=2, input_dim=2,
                           Q=2 * np.eye(2), R=np.zeros((2, 2)), capacity=512,
                           dtype=jnp.float64,
                           solver=SolverConfig(max_iters=300, tol=1e-5,
                                               polish_iters=20))
    mpc.set_gp_hyperparams(lambdas=[0.5] * 4, sigma_f=1.0, sigma_n=1e-5)
    mpc.dynamics.append_train_data(states, actions, next_states)
    mpc.set_ub([1.0, 1.0])
    mpc.set_lb([-1.0, -1.0])
    mpc.set_xref(np.array([0.0, 0.0]))
    mpc.set_uref(np.array([0.0, 0.0]))
    return mpc


if __name__ == '__main__':
    main()
