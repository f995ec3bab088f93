"""Why suite config 4's f64 fit and gradient sit further from the JAX
package's than config 3b's (ROADMAP's open question Q1). Two measurements,
both packages at f64 on the CPU, in one process:

1. The FITC posterior W = Kzz^-1 - B^-1 of each output: the two packages'
   difference (max |W_port - W_jax| / max |W_jax|) beside what the
   conditioning predicts for two backward-stable Cholesky inversions,
   eps (cond(Kzz) max|Kzz^-1| + cond(B) max|B^-1|) / max|W| (the
   difference of the inverses cancels: W is small beside them).
2. The PSD clip along config 4's 50 steps, on JAX's posterior carried into
   the port (so that both packages roll out the same model), at u = 0 and
   at the committed f64 reference controls: every pre-clip covariance of
   every step and lane, in JAX (jnp.linalg.eigh) and in the port (the
   eigensolver's plain version, eigh_small.eigh_reference); which
   eigenvalues the clip at 1e-8 raises in each (lane, step, index), and
   whether the two packages raise the same ones. Also the same JAX
   matrices through both eigensolvers, which isolates the solver; how far
   the two packages' pre-clip matrices drift apart step by step; and how
   far each package's own chain moves when x0 moves by one rounding,
   which is the recurrence's own amplification of rounding.

Run from the repository root: python tests/diagnose_torch_q1.py (~1 min).
It prints one JSON object.
"""

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_VAR = 1e-8


def _fit_parts(x, y, z, log_lambdas, log_sigma_f, log_sigma_n,
               jitter=1e-6):
    """Kzz and B of the FITC fit (gp/sparse.py's algebra), numpy f64."""
    import torch
    from gpmpc_tpu_torch.gp.kernels import se_gram_batched
    t = [torch.tensor(v, dtype=torch.float64)
         for v in (x, y, z, log_lambdas, log_sigma_f, log_sigma_n)]
    x, y, z, ll, lsf, lsn = t
    sf2 = torch.exp(2 * lsf)[:, None]
    sn2 = torch.exp(2 * lsn)[:, None]
    eye = torch.eye(z.shape[0], dtype=torch.float64)
    kzz = se_gram_batched(z, z, ll, lsf) + (jitter * sf2[..., None]
                                            + 1e-12) * eye
    kzx = se_gram_batched(z, x, ll, lsf)
    lzz = torch.linalg.cholesky(kzz)
    v = torch.linalg.solve_triangular(lzz, kzx, upper=False)
    lam = torch.maximum(sf2 - torch.sum(v * v, dim=1) + sn2, sn2)
    b = kzz + (kzx / lam[:, None, :]) @ kzx.transpose(1, 2)
    return kzz.numpy(), (0.5 * (b + b.transpose(1, 2))).numpy()


def posterior(jp, tp):
    """Measurement 1, per output."""
    eps = np.finfo(np.float64).eps
    wj, wt = np.asarray(jp.gp.kinv), tp.gp.kinv.numpy()
    rng = np.random.default_rng(0)
    n_train = 1000
    states = rng.uniform(-np.pi, np.pi, (n_train, 2))
    actions = rng.uniform(-5, 5, (n_train, 1))
    nxt = states + 0.05 * np.concatenate(
        [states[:, 1:], 15 * np.sin(states[:, :1]) + 3 * actions], axis=1)
    x = np.concatenate([states, actions], axis=1)
    sel = np.random.default_rng(4).choice(n_train, 128, replace=False)
    kzz, b = _fit_parts(x, nxt.T, x[sel], np.log(np.full((2, 3), 4.0)),
                        np.zeros(2), np.full(2, np.log(0.1)))
    out = []
    for e in range(wj.shape[0]):
        inv_k, inv_b = np.linalg.inv(kzz[e]), np.linalg.inv(b[e])
        wmax = np.abs(wj[e]).max()
        predicted = eps * (np.linalg.cond(kzz[e]) * np.abs(inv_k).max()
                           + np.linalg.cond(b[e]) * np.abs(inv_b).max()) / wmax
        out.append(dict(
            output=e, observed=float(np.abs(wt[e] - wj[e]).max() / wmax),
            predicted=float(predicted),
            cond_kzz=float(np.linalg.cond(kzz[e])),
            cond_b=float(np.linalg.cond(b[e])),
            max_inv_kzz_over_max_w=float(np.abs(inv_k).max() / wmax)))
    return out


def clip_inputs(jp, tp_carried, u, x0_scale=1.0):
    """Every step's pre-clip covariance (H, B, 2, 2) in each package, each
    rolling out its own step chain at controls u (B, H, 1) from the
    problem's x0s times x0_scale."""
    import jax.numpy as jnp
    import torch
    from gpmpc_tpu import dynamics as jd
    from gpmpc_tpu_torch import dynamics as td
    from gpmpc_tpu_torch.ops.kernels import eigh_small

    seen_j, seen_t = [], []
    jeigh, teigh = jnp.linalg.eigh, eigh_small.eigh

    def rec_j(a, *args, **kw):
        seen_j.append(np.asarray(a))
        return jeigh(a, *args, **kw)

    def rec_t(a):
        seen_t.append(a.detach().numpy().copy())
        return teigh(a)

    jcache = jd.build_rollout_cache(jp.gp, 2, 1)
    tcache = td.build_rollout_cache(tp_carried.gp, 2, 1)
    jnp.linalg.eigh, eigh_small.eigh = rec_j, rec_t
    try:
        mean, cov = jnp.asarray(jp.x0s) * x0_scale, jnp.broadcast_to(
            1e-3 * jnp.eye(2), (u.shape[0], 2, 2))
        for k in range(u.shape[1]):
            mean, cov = jd._step_batched_full(jcache, mean, cov,
                                              jnp.asarray(u[:, k]), 1e-3,
                                              False)
        with torch.no_grad():
            td.rollout_batched(tcache, tp_carried.x0s * x0_scale,
                               torch.tensor(u), full_cov=True)
    finally:
        jnp.linalg.eigh, eigh_small.eigh = jeigh, teigh
    return np.stack(seen_j), np.stack(seen_t)


def _rel_by_step(a, b):
    """max |a - b| / ||b||_F over the lanes, at steps 1, 10, 20, ..., H."""
    fro = np.linalg.norm(b, axis=(-2, -1))
    rel = np.max(np.abs(a - b) / fro[..., None, None], axis=(1, 2, 3))
    return {int(k + 1): float(rel[k])
            for k in sorted({0, *range(9, len(rel), 10), len(rel) - 1})}


def clip_firings(mats_j, mats_t):
    """Measurement 2 on one pair of step chains."""
    import jax.numpy as jnp
    import torch
    from gpmpc_tpu_torch.ops.kernels import eigh_small
    wj = np.asarray(jnp.linalg.eigh(jnp.asarray(mats_j))[0])
    wt = eigh_small.eigh_reference(torch.tensor(mats_t))[0].numpy()
    wt_on_j = eigh_small.eigh_reference(torch.tensor(mats_j))[0].numpy()
    fj, ft, ftj = wj < MIN_VAR, wt < MIN_VAR, wt_on_j < MIN_VAR
    fro = np.linalg.norm(mats_j, axis=(-2, -1))
    steps_j = sorted({int(s) for s in np.nonzero(fj.any(-1).any(-1))[0]})
    return dict(
        matrices=int(fj.shape[0] * fj.shape[1]),
        raised_jax=int(fj.sum()), raised_port=int(ft.sum()),
        disagree=int((fj != ft).sum()),
        disagree_same_inputs=int((fj != ftj).sum()),
        steps_where_jax_raises=steps_j,
        smallest_raised=float(wj[fj].min()) if fj.any() else None,
        largest_raised=float(wj[fj].max()) if fj.any() else None,
        pre_clip_rel_diff=float(np.max(np.abs(mats_t - mats_j)
                                       / fro[..., None, None])),
        eig_rel_diff_same_inputs=float(np.max(np.abs(wt_on_j - wj)
                                              / fro[..., None])),
        nearest_to_floor=float(np.min(np.abs(wj - MIN_VAR))),
        pre_clip_rel_diff_by_step=_rel_by_step(mats_t, mats_j))


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import torch

    import benchmarks.problems as jproblems
    from gpmpc_tpu_torch.problems import SPARSE_U_REF, sparse_problem

    name = '4_sparse_fullcov'
    jp = jproblems.make_sparse_fullcov_problem(b=64, dtype=jnp.float64)
    tp = sparse_problem(name, dtype=torch.float64, device='cpu')
    carried = tp._replace(gp=dataclasses.replace(
        tp.gp, kinv=torch.tensor(np.asarray(jp.gp.kinv)),
        beta=torch.tensor(np.asarray(jp.gp.beta))))
    u_ref = np.load(SPARSE_U_REF.format(name))['u_ref']
    out = dict(posterior=posterior(jp, tp))
    eps = np.finfo(np.float64).eps
    for at, u in (('zero', np.zeros_like(u_ref)), ('uref', u_ref)):
        mats_j, mats_t = clip_inputs(jp, carried, u)
        out[f'clip_{at}'] = clip_firings(mats_j, mats_t)
        # The recurrence's own sensitivity: JAX against JAX from x0s moved
        # by one rounding (1 + eps), the port likewise.
        moved_j, moved_t = clip_inputs(jp, carried, u, x0_scale=1.0 + eps)
        out[f'clip_{at}']['jax_vs_jax_x0_times_1_plus_eps'] = _rel_by_step(
            moved_j, mats_j)
        out[f'clip_{at}']['port_vs_port_x0_times_1_plus_eps'] = _rel_by_step(
            moved_t, mats_t)
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
