"""The f32 quality of the per-scenario routes and their yardsticks against
f64 solves of the same lanes and x0s, at more than one iteration cap, on
the card.

    python -m gpmpc_tpu_torch.benchmarks.f4_quality --out DIR \
        [--kinds gp,fused,full_cov,gp_floor,fused_floor] [--iters 40,300]

Each row solves one problem in f32 and in f64 with the lockstep L-BFGS
(tol 1e-4, max_iters from --iters) and scores the f32 controls under the
f64 objective of the same lanes and x0s against the f64 solve's own cost
(problems.cost_excess: p50, p90, max, lanes above 1 %), on two x0 sets:
the headline's x0s and a fresh batch, U(-1, 1)^(B, 2) from
np.random.default_rng(123) (the first fresh batch that chip_smoke.py's
timed modes solve). Kinds:
  gp        solve_batch_gp over the headline GP of seeds 0..255, one a
            lane (chip_smoke.py phase 8c (b): the f64 side solves the f32
            problem's inputs upcast);
  fused     the fused solve_batch on the headline (K1's f64 trace), the
            f64 side the f64 headline problem (phase 8c (b)'s yardstick);
  full_cov  solve_batch(full_cov=True) on the headline, as `fused`: the
            A14 off-diagonal in f32 against f64.
The score's own floor, kinds gp_floor and fused_floor: `gp` and `fused`
with the f32 side replaced by an f64 solve from x0s moved by one f32 ulp
(x0 (1 + 2^-23)), scored the same way: what a change of rounding alone
does to a lane-by-lane score of a nonconvex solve.
Beside each score: each side's loop iterations, its lanes converged (done
before the cap), and the lanes above 1 % of those converged on both sides,
so a tail of unconverged lanes shows apart from one of converged lanes.
Writes DIR/f4_quality.json and prints one JSON line a row. `run(device=
'cpu', b=4, kinds=...)` runs the path on the CPU; its numbers mean
nothing there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel.batch import (batch_objective, lanes_objective,
                                            solve_batch, solve_batch_gp,
                                            stack_gps)
from gpmpc_tpu_torch.problems import cost_excess, make_headline_problem

KINDS = ('gp', 'fused', 'full_cov')
FLOOR_KINDS = ('gp_floor', 'fused_floor')
ULP32 = 2.0 ** -23
ITERS = (40, 300)
FRESH_SEED = 123


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def fresh_x0s(b, dev) -> torch.Tensor:
    """chip_smoke.py's first fresh-x0 batch: U(-1, 1)^(b, 2), f32."""
    rng = np.random.default_rng(FRESH_SEED)
    return torch.tensor(rng.uniform(-1, 1, (b, 2)), dtype=torch.float32,
                        device=dev)


def _gp_draws(b, dtype, dev):
    return stack_gps([make_headline_problem(b=1, seed=s, dtype=dtype,
                                            device=dev).gp
                      for s in range(b)])


def _row(j64, res32, res64, wall32, wall64, cfg) -> dict:
    """The f32 result scored against the f64 one, with both sides'
    iterations and convergence."""
    q = cost_excess(j64, res32.u, res64.cost)
    with torch.no_grad():
        j = j64(res32.u.double())
    excess = ((j - res64.cost) / (1 + res64.cost.abs())).cpu().numpy()
    conv32, conv64 = (r.converged.cpu().numpy() for r in (res32, res64))
    both = conv32 & conv64
    return dict(q, lanes=len(excess), max_iters=cfg.max_iters,
                iters32=int(res32.iters.max()), iters64=int(res64.iters.max()),
                converged32=int(conv32.sum()), converged64=int(conv64.sum()),
                converged_both=int(both.sum()),
                above_1pct_converged_both=int((excess[both] > 0.01).sum()),
                above_1pct_unconverged=int((excess[~both] > 0.01).sum()),
                max_converged_both=(float(excess[both].max()) if both.any()
                                    else None),
                wall32_s=wall32, wall64_s=wall64)


def run(device=None, b=256, kinds=KINDS, iters=ITERS) -> dict:
    """Every (kind, iteration cap, x0 set) row; see the module's doc."""
    dev = resolve_device(device)
    f32, f64 = torch.float32, torch.float64
    hp = make_headline_problem(b=b, dtype=f32, device=dev)
    hp64 = make_headline_problem(b=b, dtype=f64, device=dev)
    x0_sets = {'headline x0s': hp.x0s, 'fresh x0s': fresh_x0s(b, dev)}
    cache64 = build_rollout_cache(hp64.gp, 2, 1)
    rows = {}

    def solve_pair(tag, cfg, solve32, solve64, j64):
        solver.clear_programs()
        res32, wall32 = _timed(solve32, dev)
        solver.clear_programs()
        res64, wall64 = _timed(solve64, dev)
        solver.clear_programs()
        rows[tag] = _row(j64, res32, res64, wall32, wall64, cfg)
        print(json.dumps({tag: rows[tag]}), flush=True)

    gps = gps64 = None
    if 'gp' in kinds or 'gp_floor' in kinds:
        gps, gps64 = (_gp_draws(b, dt, dev) for dt in (f32, f64))
        cache_gp64 = build_rollout_cache(gps64, 2, 1)
        p64 = hp.params._replace(**{k: getattr(hp.params, k).double()
                                    for k in ('Q', 'R', 'x_ref', 'u_ref',
                                              'gamma')})
    for n_it in iters:
        cfg = SolverConfig(max_iters=n_it, tol=1e-4)
        for label, x0s in x0_sets.items():
            x64 = x0s.double()
            moved = x64 * (1 + ULP32)
            if 'gp' in kinds:
                solve_pair(
                    f'gp {label} {n_it} it', cfg,
                    lambda: solve_batch_gp(gps, 2, 1, x0s, hp.params,
                                           hp.horizon, hp.lb, hp.ub, cfg),
                    lambda: solve_batch_gp(gps64, 2, 1, x64, p64, hp.horizon,
                                           hp.lb, hp.ub, cfg),
                    lanes_objective(cache_gp64, x64, p64))
            if 'gp_floor' in kinds:
                solve_pair(
                    f'gp_floor {label} {n_it} it', cfg,
                    lambda: solve_batch_gp(gps64, 2, 1, moved, p64,
                                           hp.horizon, hp.lb, hp.ub, cfg),
                    lambda: solve_batch_gp(gps64, 2, 1, x64, p64, hp.horizon,
                                           hp.lb, hp.ub, cfg),
                    lanes_objective(cache_gp64, x64, p64))
            for kind, full_cov in (('fused', False), ('full_cov', True)):
                if kind not in kinds:
                    continue
                # The headline's f64 x0s are its own draw; a fresh batch is
                # the f32 one upcast.
                x64k = hp64.x0s if label == 'headline x0s' else x64
                solve_pair(
                    f'{kind} {label} {n_it} it', cfg,
                    lambda: solve_batch(hp.gp, 2, 1, x0s, hp.params,
                                        hp.horizon, hp.lb, hp.ub, cfg,
                                        full_cov=full_cov),
                    lambda: solve_batch(hp64.gp, 2, 1, x64k, hp64.params,
                                        hp64.horizon, hp64.lb, hp64.ub, cfg,
                                        full_cov=full_cov),
                    batch_objective(cache64, x64k, hp64.params,
                                    full_cov=full_cov))
            if 'fused_floor' in kinds:
                x64k = hp64.x0s if label == 'headline x0s' else x64
                solve_pair(
                    f'fused_floor {label} {n_it} it', cfg,
                    lambda: solve_batch(hp64.gp, 2, 1, x64k * (1 + ULP32),
                                        hp64.params, hp64.horizon, hp64.lb,
                                        hp64.ub, cfg),
                    lambda: solve_batch(hp64.gp, 2, 1, x64k, hp64.params,
                                        hp64.horizon, hp64.lb, hp64.ub, cfg),
                    batch_objective(cache64, x64k, hp64.params))
    return dict(b=b, device=(torch.cuda.get_device_name(dev)
                             if dev.type == 'cuda' else dev.type), rows=rows)


def main() -> int:
    from gpmpc_tpu_torch.benchmarks.chain import card_line
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', required=True, help='directory for '
                    'f4_quality.json')
    ap.add_argument('--kinds', default=','.join(KINDS),
                    help=f'of {KINDS + FLOOR_KINDS}')
    ap.add_argument('--iters', default=','.join(map(str, ITERS)))
    args = ap.parse_args()
    card = card_line()
    print(card, flush=True)
    res = run(kinds=tuple(args.kinds.split(',')),
              iters=tuple(int(n) for n in args.iters.split(',')))
    res['card'] = card
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'f4_quality.json'), 'w') as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
