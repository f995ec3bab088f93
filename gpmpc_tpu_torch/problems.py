"""The headline problem (port of `make_headline_problem`,
benchmarks/problems.py).

B independent risk-sensitive GP-MPC solves against a shared exact-GP
pendulum-dimension posterior (ds = 2, da = 1): N = 200 training points in
capacity 256, tied lengthscales 4, sigma_n = 0.1, horizon 20, a gamma sweep
over [-0.5, 0.5] and bounds +-5. The data come from numpy with the same seed
and draw order as the JAX package, so both build the same GP.
"""

from __future__ import annotations

from typing import NamedTuple

import functools
import os

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.gp.state import GPConfig, GPState, make_gp
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.parallel.batch import batch_objective

# The JAX package's f64 objective at the committed f64 reference controls
# (tests/make_torch_headline_ref.py): u_ref, j_uref, j_zero, grad_zero.
REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                        'headline_ref.npz')


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
    """Solution quality of controls u (B, H, 1) on the headline problem: the
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
