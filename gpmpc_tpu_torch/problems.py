"""The benchmark problems (port of benchmarks/problems.py:
`make_headline_problem`, `cartpole_data`, `make_sparse_cartpole_problem`,
`make_sparse_fullcov_problem`).

The headline problem: B independent risk-sensitive GP-MPC solves against a
shared exact-GP pendulum-dimension posterior (ds = 2, da = 1): N = 200
training points in capacity 256, tied lengthscales 4, sigma_n = 0.1, horizon
20, a gamma sweep over [-0.5, 0.5] and bounds +-5. The sparse problems, the
benchmark suite's configs 3b and 4: N = 1,000 transitions through a FITC GP
of M = 128 inducing points (gp/sparse.py). The data come from numpy with the
same seeds and draw order as the JAX package, so both build the same GPs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import functools
import os

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.envs.cartpole import CartPoleParams
from gpmpc_tpu_torch.gp.sparse import fit_sparse
from gpmpc_tpu_torch.gp.state import GPConfig, GPState, make_gp
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.parallel.batch import batch_objective

# The JAX package's f64 objective at the committed f64 reference controls
# (tests/make_torch_headline_ref.py): u_ref, j_uref, j_zero, grad_zero.
REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                        'headline_ref.npz')
# The JAX package's f64 values on the sparse workloads
# (tests/make_torch_sparse_ref.py).
SPARSE_REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'data', 'sparse_ref.npz')
# The suite's sparse workloads (benchmarks/quality_sparse.py's WORKLOADS):
# maker, lanes and covariance; their f64 reference controls (u_ref) are
# benchmarks/results/quality_sparse_ref_<name>.npz.
SPARSE_WORKLOADS = {
    '3b_sparse_cartpole': dict(maker='make_sparse_cartpole_problem', b=256,
                               full_cov=False),
    '4_sparse_fullcov': dict(maker='make_sparse_fullcov_problem', b=64,
                             full_cov=True),
}
SPARSE_U_REF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'benchmarks', 'results',
    'quality_sparse_ref_{}.npz')


# The headline inputs' range: (theta, omega, action) in [-pi, pi]^2 x [-5, 5].
DATA_SCALE = np.array([np.pi, np.pi, 5.0])

# The production recipe on this problem, `ret_prod_nopre`: the keyword
# arguments of parallel.batch.solve_batch_multistart_retired (RECIPE) and its
# refinement solver (REFINE, a SolverConfig). A copy of bench.py's RECIPE and
# REFINE in the JAX package's repository; keep the two in step.
RECIPE_NAME = 'ret_prod_nopre'
RECIPE = dict(n_starts=8, prune_to=4, budget1=60, tail_divisor=4,
              shift_set=(1, -1, 2, -2), shift_iters=48, shift_top=2,
              shift_smooth_iters=8, shift_margin=0.005,
              shift_lanes_per_chunk=64, shift_rounds=2, shift_max_lanes=64,
              neighbor_set=6, neighbor_shifted=1, propose_smoothed=True,
              polish_lanes=64, polish_iters=96, pregate=False)
REFINE = dict(max_iters=60, tol=1e-4, noise_rel=3e-4, progress_window=24)


class HeadlineProblem(NamedTuple):
    gp: GPState
    state_dim: int
    action_dim: int
    x0s: torch.Tensor         # (B, ds)
    params: CostParams        # gamma is a (B,) sweep
    horizon: int
    lb: float
    ub: float


def make_headline_problem(b: int = 256, dtype=torch.float32, seed: int = 0,
                          n_train: int = 200, capacity: int = 256,
                          horizon: int = 20, device=None) -> HeadlineProblem:
    """The headline workload; dtype float32 is the production precision,
    float64 the reference objective. `device` defaults to CUDA."""
    dev = resolve_device(device)
    ds, da = 2, 1
    rng = np.random.default_rng(seed)
    states = rng.uniform(-np.pi, np.pi, (n_train, ds))
    actions = rng.uniform(-5, 5, (n_train, da))
    next_states = states + 0.05 * np.concatenate(
        [states[:, 1:], 15 * np.sin(states[:, :1]) + 3 * actions], axis=1)
    x = np.concatenate([states, actions], axis=1)
    cfg = GPConfig(capacity=capacity, x_dim=ds + da, out_dim=ds)
    gp = make_gp(cfg, x, next_states, log_lambdas=np.log([4.0] * (ds + da)),
                 log_sigma_f=0.0, log_sigma_n=np.log(0.1), dtype=dtype,
                 device=dev)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    x0s = t(rng.uniform(-1, 1, (b, ds)))
    params = CostParams(Q=t(2.0 * np.eye(ds)), R=t(0.01 * np.eye(da)),
                        gamma=t(np.linspace(-0.5, 0.5, b)),
                        x_ref=t(np.zeros(ds)), u_ref=t(np.zeros(da)))
    return HeadlineProblem(gp=gp, state_dim=ds, action_dim=da, x0s=x0s,
                           params=params, horizon=horizon, lb=-5.0, ub=5.0)


def cartpole_data(n_train: int, seed: int = 0):
    """Cartpole transitions from numpy: uniform states and forces, stepped by
    host f64 physics (envs.cartpole.step_physics's equations), bit-equal to
    the JAX package's. Returns (x (n, 5), next_states (n, 4)) float64."""
    rng0 = np.random.default_rng(seed)
    st = np.stack([rng0.uniform(-2.4, 2.4, n_train),
                   rng0.uniform(-2.0, 2.0, n_train),
                   rng0.uniform(-np.pi / 4, np.pi / 4, n_train),
                   rng0.uniform(-2.0, 2.0, n_train)], axis=1)
    ac = rng0.uniform(-1.0, 1.0, (n_train, 1))
    pp = CartPoleParams()
    force = pp.force_mag * ac[:, 0]
    xp, xd, th, thd = st[:, 0], st[:, 1], st[:, 2], st[:, 3]
    total_mass = pp.masscart + pp.masspole
    pml = pp.masspole * pp.length
    ct, stn = np.cos(th), np.sin(th)
    temp = (force + pml * thd ** 2 * stn) / total_mass
    thacc = (pp.gravity * stn - ct * temp) / (
        pp.length * (4.0 / 3.0 - pp.masspole * ct ** 2 / total_mass))
    xacc = temp - pml * thacc * ct / total_mass
    ns = np.stack([xp + pp.tau * xd, xd + pp.tau * xacc,
                   th + pp.tau * thd, thd + pp.tau * thacc], axis=1)
    return np.concatenate([st, ac], axis=1), ns


def _sparse_gp(x, ns, sel, lam, dtype, dev):
    """fit_sparse on rows `sel` of x as Z, tied lengthscales `lam`,
    sigma_f = 1, sigma_n = 0.1, in `dtype` on `dev`."""
    ds, d = ns.shape[1], x.shape[1]

    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    gp, _ = fit_sparse(t(x[sel]), t(x), t(ns.T), t(np.log(np.full((ds, d),
                                                                   lam))),
                       t(np.zeros(ds)), t(np.full(ds, np.log(0.1))))
    return gp


def make_sparse_cartpole_problem(b: int = 256, dtype=torch.float32,
                                 seed: int = 0, n_train: int = 1000,
                                 m: int = 128, horizon: int = 10,
                                 device=None) -> HeadlineProblem:
    """Suite config 3b: cartpole N = 1,000 through the FITC GP (M = 128,
    tied lengthscales 2), gamma = 0, H = 10, bounds +-1."""
    dev = resolve_device(device)
    ds, da = 4, 1
    x, ns = cartpole_data(n_train, seed)
    rng = np.random.default_rng(seed + 3)
    sel = rng.choice(n_train, m, replace=False)
    gp = _sparse_gp(x, ns, sel, 2.0, dtype, dev)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    x0s = t(rng.uniform(-0.2, 0.2, (b, ds)))
    params = CostParams(Q=t(np.eye(ds)), R=t(0.1 * np.eye(da)),
                        gamma=t(0.0), x_ref=t(np.zeros(ds)),
                        u_ref=t(np.zeros(da)))
    return HeadlineProblem(gp=gp, state_dim=ds, action_dim=da, x0s=x0s,
                           params=params, horizon=horizon, lb=-1.0, ub=1.0)


def make_sparse_fullcov_problem(b: int = 64, dtype=torch.float32,
                                seed: int = 0, n_train: int = 1000,
                                m: int = 128, horizon: int = 50,
                                device=None) -> HeadlineProblem:
    """Suite config 4: the headline's pendulum data at N = 1,000 through the
    FITC GP (M = 128, tied lengthscales 4), solved with the full
    cross-output covariance, H = 50, gamma = -0.01, bounds +-5."""
    dev = resolve_device(device)
    ds, da = 2, 1
    rng = np.random.default_rng(seed)
    states = rng.uniform(-np.pi, np.pi, (n_train, ds))
    actions = rng.uniform(-5, 5, (n_train, da))
    next_states = states + 0.05 * np.concatenate(
        [states[:, 1:], 15 * np.sin(states[:, :1]) + 3 * actions], axis=1)
    x = np.concatenate([states, actions], axis=1)
    rng4 = np.random.default_rng(seed + 4)
    sel = rng4.choice(n_train, m, replace=False)
    gp = _sparse_gp(x, next_states, sel, 4.0, dtype, dev)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    x0s = t(rng4.uniform(-1, 1, (b, ds)))
    params = CostParams(Q=t(2.0 * np.eye(ds)), R=t(0.01 * np.eye(da)),
                        gamma=t(-1e-2), x_ref=t(np.zeros(ds)),
                        u_ref=t(np.zeros(da)))
    return HeadlineProblem(gp=gp, state_dim=ds, action_dim=da, x0s=x0s,
                           params=params, horizon=horizon, lb=-5.0, ub=5.0)


def sparse_problem(name: str, b: Optional[int] = None, dtype=torch.float32,
                   device=None) -> HeadlineProblem:
    """A sparse workload of SPARSE_WORKLOADS by name, at its own B unless
    given."""
    wl = SPARSE_WORKLOADS[name]
    maker = {'make_sparse_cartpole_problem': make_sparse_cartpole_problem,
             'make_sparse_fullcov_problem': make_sparse_fullcov_problem}
    return maker[wl['maker']](b=wl['b'] if b is None else b, dtype=dtype,
                              device=device)


def sparse_j64(name: str, device=None):
    """The f64 objective J64: (B, H, 1) -> (B,) of a sparse workload: its
    f64 FITC posterior of the same data, with the workload's covariance (the
    yardstick of cost_excess, as benchmarks/quality_sparse.py scores)."""
    p64 = sparse_problem(name, dtype=torch.float64, device=device)
    return batch_objective(build_rollout_cache(p64.gp, p64.state_dim,
                                               p64.action_dim), p64.x0s,
                           p64.params,
                           full_cov=SPARSE_WORKLOADS[name]['full_cov'])


def headline_operands(rng, b, cache, tied=True):
    """Operands of the variance trace on the headline GP's own x (N, d) and
    b_lam (E, N, N), taken from `cache`: u ~ U(-1, 1) x DATA_SCALE (B, d)
    and random SPD M2 = (0.1 m m^T + I) / 2, (B, d, d), or (B, E, d, d)
    untied, drawn from `rng`; f64 on the cache's device."""
    d, e = cache.x.shape[1], cache.b_lam.shape[0]
    u = rng.uniform(-1.0, 1.0, (b, d)) * DATA_SCALE
    m = rng.normal(size=(b, d, d) if tied else (b, e, d, d))
    m2 = 0.5 * (m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d))
    f64 = functools.partial(torch.tensor, dtype=torch.float64,
                            device=cache.x.device)
    return (f64(u), f64(m2), cache.x.to(torch.float64),
            cache.b_lam.to(torch.float64))


def headline_j64(b: int = 256, device=None):
    """The f64 headline objective J64: (B, H, 1) -> (B,), the yardstick of
    solution quality (through the f64 kernel instances on the card)."""
    p64 = make_headline_problem(b=b, dtype=torch.float64, device=device)
    return batch_objective(build_rollout_cache(p64.gp, 2, 1), p64.x0s,
                           p64.params)


def cost_excess(j64, u: torch.Tensor, j_ref: torch.Tensor) -> dict:
    """Solution quality of controls u (B, H, 1) under the f64 objective j64
    (headline_j64, sparse_j64): the
    per-lane excess (J64(u) - J64(u_ref)) / (1 + |J64(u_ref)|) against the
    reference costs j_ref, summarised as p50, p90, max and the lanes above
    1 % (as benchmarks/quality_retired.py scores the JAX recipe)."""
    with torch.no_grad():
        j_sol = j64(u.to(torch.float64))
    excess = ((j_sol - j_ref) / (1 + j_ref.abs())).cpu().numpy()
    return dict(p50=float(np.percentile(excess, 50)),
                p90=float(np.percentile(excess, 90)),
                max=float(excess.max()),
                lanes_above_1pct=int((excess > 0.01).sum()))
