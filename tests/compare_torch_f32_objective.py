"""How far the f32 objective of each package sits from the f64 reference, on
the CPU: the JAX package's and the port's headline objective in f32 at the
reference controls, against the JAX f64 values stored in
gpmpc_tpu_torch/data/headline_ref.npz, and the port's f64 objective against
the same values. Prints one JSON line.

The trace cancels in f32 (its terms' magnitudes sum to 1e3-1e6 times the
result), so the f32 objective carries an error of its own; this script
shows that the port's f32 error is the JAX package's, not the port's.

Run from the repository root: python tests/compare_torch_f32_objective.py
[--lanes 32]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--lanes', type=int, default=32)
    lanes = ap.parse_args().lanes
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import torch

    from benchmarks.problems import make_headline_problem as jmake
    from gpmpc_tpu.dynamics import build_rollout_cache as jcache
    from gpmpc_tpu.dynamics import rollout_batched
    from gpmpc_tpu.mpc.cost import risk_sensitive_cost
    from gpmpc_tpu.parallel.batch import _params_axes
    from gpmpc_tpu_torch.dynamics import build_rollout_cache as tcache
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    from gpmpc_tpu_torch.problems import make_headline_problem as tmake

    ref = np.load(os.path.join(ROOT, 'gpmpc_tpu_torch', 'data',
                               'headline_ref.npz'))
    u_ref, j_ref = ref['u_ref'][:lanes], ref['j_uref'][:lanes]

    def rel(j):
        return np.abs(np.asarray(j, np.float64) / j_ref - 1.0)

    jp = jmake(b=256, dtype=jnp.float32)
    params = jp.params._replace(gamma=jp.params.gamma[:lanes])
    cost_b = jax.vmap(risk_sensitive_cost,
                      in_axes=(_params_axes(params), 0, 0, 0))
    u32 = jnp.asarray(u_ref, jnp.float32)
    means, covs = rollout_batched(jcache(jp.gp, 2, 1), jp.x0s[:lanes], u32)
    out = {'lanes': lanes, 'jax_f32': rel(cost_b(params, means, covs, u32))}

    for name, dtype in (('port_f32', torch.float32),
                        ('port_f64', torch.float64)):
        tp = tmake(b=256, dtype=dtype, device='cpu')
        obj = batch_objective(
            tcache(tp.gp, 2, 1), tp.x0s[:lanes],
            tp.params._replace(gamma=tp.params.gamma[:lanes]))
        with torch.no_grad():
            out[name] = rel(obj(torch.tensor(u_ref, dtype=dtype)).numpy())
    for k in ('jax_f32', 'port_f32', 'port_f64'):
        v = out.pop(k)
        out[k] = {'rel_err_p50': float(np.median(v)),
                  'rel_err_max': float(v.max())}
    print(json.dumps(out))


if __name__ == '__main__':
    main()
