"""Fault F4 (ROADMAP §3): the per-scenario routes' f32 quality. Where the
f32 error of the lanes routes' objective comes from, measured on the CPU in
one process, the port beside the JAX package:

1. At the headline GP (N = 200 in capacity 256, E = 2), at the joint means
   and covariances of steps STEPS of an f64 lanes rollout of LANES lanes
   (two control sets: zero and a uniform draw in the box), the f32
   evaluation of each single-input quantity against the f64 evaluation of
   the same f32 operands: the trace t, the term det t, the variance
   sigma_f^2 - det t - m^2, the mean's pair sum (`_pair_dot`) and, with a
   full covariance, the off-diagonal of `covariance_prop` (eq. A14). Each
   error relative to the result and to its terms' magnitude sum (the same
   quantity with every term made positive); p90 and max over lanes, steps
   and outputs. The variance is read three ways: the plain f32 chain (the
   port before the f64 single-input trace), the port as it is (the trace in
   f64, the rest in f32), and the f64 trace with f64 means (what the
   subtraction alone costs).
2. The f32 lanes objective (`parallel.batch.lanes_objective`) over LANES
   GP draws (the headline data of seeds 0..LANES-1, one GP a lane) against
   the f64 objective at the same controls: |J32 - J64| / (1 + |J64|) and
   the gradient's relative error, and the error of its differences along
   a direction (what a line search reads), with the plain f32 chain and
   as it is.
3. JAX's own f32 jax.vmap of its single-scenario objective (gpmpc_tpu's
   rollout and risk_sensitive_cost, lane by lane its GP) at the same
   inputs, against JAX's f64: whether the JAX package shares the fault.
4. A LANES-lane f32 solve_batch_gp (40 L-BFGS iterations, tol 1e-4, as
   chip_smoke.py's phase 8c (b)) against the f64 solve of the same lanes
   and x0s, scored under the f64 objective (problems.cost_excess), with
   the plain f32 chain and as it is.

"The plain f32 chain" replaces `moments._single_trace` by a call of the
chain on its operands as they are. Run from the repository root:
python tests/diagnose_torch_f4.py (~3 min). It prints one JSON object.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 16
STEPS = (1, 5, 10, 19)
ITERS = 40
FD_STEPS = (1e-4, 1e-3, 1e-2)


def _plain(chain, u, S, x, b_lam, log_lambdas):
    """The single-input trace before the policy: the chain in the
    operands' dtype."""
    return chain(u, S, x, b_lam, log_lambdas)


def _summary(err, res, mag) -> dict:
    err, res, mag = (np.abs(np.asarray(v, dtype=np.float64)).ravel()
                     for v in (err, res, mag))
    rel, rel_mag = err / res, err / mag
    return dict(rel_to_result_p90=float(np.percentile(rel, 90)),
                rel_to_result_max=float(rel.max()),
                rel_to_terms_p90=float(np.percentile(rel_mag, 90)),
                rel_to_terms_max=float(rel_mag.max()),
                terms_over_result_max=float((mag / res).max()))


def joint_operands(controls, full_cov):
    """(u, S) (LANES * len(STEPS), 3) and (.., 3, 3): the joint means and
    covariances that `dynamics._step` forms at steps STEPS of an f64 lanes
    rollout of the headline GP from the headline's x0s under controls,
    rounded to f32 (the f32 operands), as f64 tensors."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout_lanes
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=LANES, dtype=torch.float64, device='cpu')
    cache = build_rollout_cache(p.gp, 2, 1)
    means, covs = rollout_lanes(cache, p.x0s, controls, full_cov=full_cov)
    idx = list(STEPS)
    m, c, a = means[:, idx], covs[:, idx], controls[:, idx]
    u = torch.cat([m, a], dim=-1).reshape(-1, 3)
    s = torch.zeros(u.shape[0], 3, 3, dtype=torch.float64)
    s[:, :2, :2] = c.reshape(-1, 2, 2)
    s[:, 2, 2] = 1e-3
    return u.float().double(), s.float().double()


def quantities(controls) -> dict:
    """Measurement 1 at one control set."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.ops import moments as tm
    from gpmpc_tpu_torch.problems import make_headline_problem
    f32, f64 = torch.float32, torch.float64
    c32 = build_rollout_cache(make_headline_problem(
        b=2, dtype=f32, device='cpu').gp, 2, 1)
    x, blam, ll, lsf, beta, mask = (c32.x, c32.b_lam, c32.log_lambdas,
                                    c32.log_sigma_f, c32.beta, c32.mask)
    vm = torch.func.vmap
    out = {}
    with torch.no_grad():
        u, s = joint_operands(controls, full_cov=False)

        def at(dt):
            return [v.to(dt) for v in (u, s, x, blam, ll, lsf, beta)]

        def means_of(uu, ss, xx, bb, l, sf):
            return torch.stack([vm(lambda a, c: tm.mean_prop(
                a, c, xx, bb[k], l[k], sf[k], mask)[0])(uu, ss)
                for k in range(bb.shape[0])], dim=-1)

        u32, s32, x32, b32, l32, sf32, be32 = at(f32)
        u64, s64, x64, b64, l64, sf64, be64 = at(f64)
        t32, ld32 = vm(tm._trace_multi, in_dims=(0, 0, None, None, None))(
            u32, s32, x32, b32, l32)
        t64, ld64 = vm(tm._trace_multi, in_dims=(0, 0, None, None, None))(
            u64, s64, x64, b64, l64)
        t_mag = vm(tm._trace_multi, in_dims=(0, 0, None, None, None))(
            u64, s64, x64, b64.abs(), l64)[0]
        out['trace t'] = _summary(t32.double() - t64, t64, t_mag)
        dt32, dt64 = torch.exp(ld32) * t32, torch.exp(ld64) * t64
        out['det t'] = _summary(dt32.double() - dt64, dt64,
                                torch.exp(ld64) * t_mag)
        m32 = means_of(u32, s32, x32, be32, l32, sf32)
        m64 = means_of(u64, s64, x64, be64, l64, sf64)
        m_mag = means_of(u64, s64, x64, be64.abs(), l64, sf64)
        out['mean (_pair_dot)'] = _summary(m32.double() - m64, m64, m_mag)
        sf2 = torch.exp(2.0 * sf64)
        v64 = sf2 - dt64 - m64 ** 2
        v_mag = sf2 + dt64.abs() + m64 ** 2
        v_plain = sf2.float() - dt32 - m32 ** 2
        multi = vm(tm.variance_prop_multi,
                   in_dims=(0, 0, None, None, None, None, 0))
        v_now = multi(u32, s32, x32, b32, l32, sf32, m32)
        v_m64 = multi(u32, s32, x32, b32, l32, sf32, m64.float())
        out['variance, plain f32 chain'] = _summary(
            v_plain.double() - v64, v64, v_mag)
        out['variance, f64 trace (as it is)'] = _summary(
            v_now.double() - v64, v64, v_mag)
        out['variance, f64 trace and exact means'] = _summary(
            v_m64.double() - v64, v64, v_mag)

        u, s = joint_operands(controls, full_cov=True)
        u32, s32, x32, b32, l32, sf32, be32 = at(f32)
        u64, s64, x64, b64, l64, sf64, be64 = at(f64)
        m32 = means_of(u32, s32, x32, be32, l32, sf32)
        m64 = means_of(u64, s64, x64, be64, l64, sf64)

        def a14(uu, ss, xx, b1, b2, l, sf, mm):
            return vm(lambda a, c, m: tm.covariance_prop(
                a, c, xx, b1, b2, l[0], l[1], sf[0], sf[1], mask, m[0],
                m[1]))(uu, ss, mm)

        c32v = a14(u32, s32, x32, be32[0], be32[1], l32, sf32, m32)
        c64v = a14(u64, s64, x64, be64[0], be64[1], l64, sf64, m64)
        c_mag = (a14(u64, s64, x64, be64[0].abs(), be64[1].abs(), l64, sf64,
                     torch.zeros_like(m64)) + (m64[:, 0] * m64[:, 1]).abs())
        out['A14 off-diagonal (full covariance)'] = _summary(
            c32v.double() - c64v, c64v, c_mag)
    return out


def draws(dtype):
    """(stacked GPState of the headline GP of seeds 0..LANES-1, the
    headline problem at LANES lanes) in the port."""
    from gpmpc_tpu_torch.parallel.batch import stack_gps
    from gpmpc_tpu_torch.problems import make_headline_problem
    gps = stack_gps([make_headline_problem(b=1, seed=s, dtype=dtype,
                                           device='cpu').gp
                     for s in range(LANES)])
    return gps, make_headline_problem(b=LANES, dtype=dtype, device='cpu')


def port_objective(dtype):
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.parallel.batch import lanes_objective
    gps, hp = draws(dtype)
    j = lanes_objective(build_rollout_cache(gps, 2, 1), hp.x0s, hp.params)

    def value_and_grad(u):
        u = u.to(dtype).clone().requires_grad_()
        val = j(u)
        (g,) = torch.autograd.grad(val.sum(), u)
        return val.detach().double(), g.double()
    return value_and_grad


def objective_errors(controls) -> dict:
    """Measurement 2 at each control set: the port's f32 lanes objective
    against its f64 one, in value and gradient, and in its differences
    along a random direction v (|v| <= 1 a control): the error of
    J32(u + s v) - J32(u) against the f64 difference, relative to it, at
    the steps FD_STEPS (what a line search reads)."""
    import torch
    from gpmpc_tpu_torch.ops import moments as tm
    j64 = port_objective(torch.float64)
    v = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (LANES, 20, 1)))
    out = {}
    for name, u in controls.items():
        v64, g64 = j64(u)
        d64 = {s: j64((u + s * v).float().double())[0] - v64
               for s in FD_STEPS}
        row = {}
        for how in ('plain f32 chain', 'f64 trace (as it is)'):
            policy = tm._single_trace
            if how == 'plain f32 chain':
                tm._single_trace = _plain
            try:
                j32 = port_objective(torch.float32)
                v32, g32 = j32(u)
                d32 = {s: j32((u + s * v).float().double())[0] - v32
                       for s in FD_STEPS}
            finally:
                tm._single_trace = policy
            rel = ((v32 - v64).abs() / (1 + v64.abs())).numpy()
            g_rel = (torch.linalg.vector_norm(g32 - g64, dim=(1, 2))
                     / torch.linalg.vector_norm(g64, dim=(1, 2))).numpy()
            row[how] = dict(j_rel_p90=float(np.percentile(rel, 90)),
                            j_rel_max=float(rel.max()),
                            grad_rel_p90=float(np.percentile(g_rel, 90)),
                            grad_rel_max=float(g_rel.max()))
            for s in FD_STEPS:
                e = ((d32[s] - d64[s]).abs() / d64[s].abs()).numpy()
                row[how][f'diff_rel_p90_step_{s:g}'] = float(
                    np.percentile(e, 90))
        out[name] = row
    return out


def jax_objective_errors(controls) -> dict:
    """Measurement 3: JAX's f32 jax.vmap of its single-scenario objective
    against JAX's f64, at the same controls and GP draws; and JAX's f64
    against the port's f64 (the two packages' objectives agree)."""
    import jax
    import jax.numpy as jnp
    import torch

    import benchmarks.problems as jproblems
    from gpmpc_tpu import dynamics as jdyn
    from gpmpc_tpu.mpc.cost import risk_sensitive_cost
    from gpmpc_tpu.parallel.batch import stack_gps

    def objective(dtype):
        gps = stack_gps([jproblems.make_headline_problem(
            b=1, seed=s, dtype=dtype).gp for s in range(LANES)])
        hp = jproblems.make_headline_problem(b=LANES, dtype=dtype)

        def one(gp, x0, u, gamma):
            cache = jdyn.build_rollout_cache(gp, 2, 1)
            means, covs = jdyn.rollout(cache, x0, u)
            return risk_sensitive_cost(hp.params._replace(gamma=gamma),
                                       means, covs, u)
        fn = jax.jit(jax.vmap(jax.value_and_grad(one, argnums=2)))
        return lambda u: [np.asarray(v, np.float64) for v in fn(
            gps, hp.x0s, jnp.asarray(u, dtype), hp.params.gamma)]

    j32, j64 = objective(jnp.float32), objective(jnp.float64)
    port64 = port_objective(torch.float64)
    out = {}
    for name, u in controls.items():
        (v32, g32), (v64, g64) = j32(u.numpy()), j64(u.numpy())
        rel = np.abs(v32 - v64) / (1 + np.abs(v64))
        g_rel = (np.linalg.norm((g32 - g64).reshape(LANES, -1), axis=1)
                 / np.linalg.norm(g64.reshape(LANES, -1), axis=1))
        pv = port64(u)[0].numpy()
        out[name] = dict(j_rel_p90=float(np.percentile(rel, 90)),
                         j_rel_max=float(rel.max()),
                         grad_rel_p90=float(np.percentile(g_rel, 90)),
                         grad_rel_max=float(g_rel.max()),
                         jax64_vs_port64_rel_max=float(np.max(
                             np.abs(v64 - pv) / (1 + np.abs(pv)))))
    return out


def solve(dtype):
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch_gp
    gps, hp = draws(dtype)
    return solve_batch_gp(gps, 2, 1, hp.x0s, hp.params, hp.horizon, hp.lb,
                          hp.ub, SolverConfig(max_iters=ITERS, tol=1e-4))


def solve_quality(res64) -> dict:
    """Measurement 4: the f32 solves against the f64 one (res64)."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.ops import moments as tm
    from gpmpc_tpu_torch.parallel.batch import lanes_objective
    from gpmpc_tpu_torch.problems import cost_excess
    gps, hp = draws(torch.float64)
    j64 = lanes_objective(build_rollout_cache(gps, 2, 1), hp.x0s, hp.params)
    out = {}
    for how in ('plain f32 chain', 'f64 trace (as it is)'):
        policy = tm._single_trace
        if how == 'plain f32 chain':
            tm._single_trace = _plain
        try:
            res32 = solve(torch.float32)
        finally:
            tm._single_trace = policy
        out[how] = dict(cost_excess(j64, res32.u, res64.cost),
                        iters=res32.iters.tolist())
    out['f64 iterations'] = res64.iters.tolist()
    return out


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import torch
    torch.set_num_threads(4)

    res64 = solve(torch.float64)
    rng = np.random.default_rng(3)
    controls = {
        'zero': torch.zeros(LANES, 20, 1, dtype=torch.float64),
        'uniform': torch.tensor(rng.uniform(-5, 5, (LANES, 20, 1))).float()
        .double(),
        'f64 solve': res64.u.float().double()}
    out = dict(
        quantities={k: quantities(controls[k]) for k in ('zero', 'uniform')},
        objective=objective_errors(controls),
        jax_objective=jax_objective_errors(controls),
        solve=solve_quality(res64))
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
