"""Device-episode walls and kept-program sizes of two checkouts of this
repository on one card, in turns.

Each checkout runs `run_episode_on_device` in a child process of its own, as
chip_smoke.py's closed-loop phase (e) drives it: the pendulum
(max_torque 3), 20 random transitions from one seed in a 32-point f64 GP
with lengthscales 3 and noise 0.05, x0 = (0.5, 0), horizon 3, Q = 2 I,
R = 0.1, gamma 0, actions in [-3, 3], L-BFGS at 25 iterations, --steps
steps with the GP appended online. Kind 'plain' fits delta dynamics
(the single-scenario route without a nominal model); kind 'nominal' fits
the next state around the pendulum's nominal model
(models/pendulum.nominal_residual_fn) on the same transitions. A kind's
first episode builds what the checkout keeps (its captured programs);
--reps more episodes of the same kind then run on what was kept. Each
episode reports its wall and its states; after a kind, the kernel nodes of
each kept program's init graph (one value-and-grad and the solver's init)
and step graph (one value-and-grad and an iteration), read from the graphs
(utils/replay_counts.py), or none where the checkout keeps no program.
Kind 'batched' runs the checkout's own chip_smoke.py phase 9c episode
(`chip_smoke.episode_problem`: 256 pendulum lanes, capacity 512, H = 8, the
multistart route over one GP a lane, 100 iterations) for --steps steps
through `chip_smoke.run_batched`, and reports, besides the walls and states,
the kept programs' bytes (solver.program_stats). --kinds picks the kinds.
The checkouts run in the order A, B, B, A, so that a drift of the card or
its host shows as a spread between the two runs of one side.

Run on the card's machine, from the root of checkout B, with checkout A
unpacked beside it (e.g. `git archive <commit> | tar -x -C _checkout/a`):

    python -m gpmpc_tpu_torch.benchmarks.compare_episode _checkout/a . \
        --out compare_out [--steps 10 --reps 3 --kinds plain,nominal,batched]

It prints each run's lines and writes DIR/compare_episode.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from gpmpc_tpu_torch.envs import pendulum
from gpmpc_tpu_torch.envs.pendulum import PendulumParams
from gpmpc_tpu_torch.gp import state as gp_state
from gpmpc_tpu_torch.models.pendulum import nominal_residual_fn
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.sim.simulator import run_episode_on_device
steps, reps = int(sys.argv[2]), int(sys.argv[3])
kinds = sys.argv[4].split(',')
dev = torch.device('cuda')
f64 = dict(dtype=torch.float64, device=dev)
p = PendulumParams(max_torque=3.0)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
s, a, ns = pendulum.sample_transitions(gen, 20, p, **f64)
cp = CostParams(Q=2 * torch.eye(2, **f64), R=0.1 * torch.eye(1, **f64),
                gamma=torch.tensor(0.0, **f64), x_ref=torch.zeros(2, **f64),
                u_ref=torch.zeros(1, **f64))

def gp_of(kind):
    nominal = kind == 'nominal'
    return gp_state.make_gp(
        gp_state.GPConfig(capacity=32, x_dim=3, out_dim=2,
                          nominal_fn=nominal_residual_fn if nominal else None),
        torch.cat([s, a], 1).cpu().numpy(),
        (ns if nominal else ns - s).cpu().numpy(),
        log_lambdas=np.log(np.full((2, 3), 3.0)),
        log_sigma_n=np.log(np.full(2, 0.05)), **f64)

def nodes():
    kept = getattr(solver, '_PROGRAMS', {})
    return [{k: sum(getattr(prog, k + '_counts').names.values())
             for k in ('init', 'step') if hasattr(prog, k + '_counts')}
            for prog in kept.values()]

def batched():
    import chip_smoke as cs
    problem = cs.episode_problem(dev)
    walls = []
    for rep in range(1 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = cs.run_batched(problem, steps, 'multistart', guard=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    states = outs['state'].cpu().numpy()
    if not np.isfinite(states).all():
        raise AssertionError('batched: states not finite')
    res = dict(walls_s=walls, nodes=nodes(), states=states.tolist(),
               actions=outs['action'].cpu().numpy().tolist(),
               iters=outs['iters'].cpu().numpy().tolist(),
               program_bytes=solver.program_stats()['bytes'])
    solver.clear_programs()
    return res

out = {}
if 'batched' in kinds:
    out['batched'] = batched()
for kind in [k for k in kinds if k != 'batched']:
    gp = gp_of(kind)
    walls, states = [], None
    for rep in range(1 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = run_episode_on_device(
            gp, lambda st, u: pendulum.step(st, u, p),
            torch.tensor([0.5, 0.0], **f64), cp, horizon=3, num_steps=steps,
            lb=-3.0, ub=3.0, solver=SolverConfig(max_iters=25),
            delta_dynamics=kind == 'plain')
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        states = outs['state'].cpu().numpy()
        if not np.isfinite(states).all():
            raise AssertionError(f'{kind}: states not finite')
    out[kind] = dict(walls_s=walls, nodes=nodes(), states=states.tolist(),
                     iters=outs['iters'].cpu().numpy().tolist())
    if hasattr(solver, 'clear_programs'):
        solver.clear_programs()
print('RESULT ' + json.dumps(out), flush=True)
'''


def run_checkout(root: str, steps: int, reps: int, kinds: str,
                 timeout: int = 1800) -> dict:
    """One child process's episodes in the checkout at `root`."""
    out = subprocess.run(
        [sys.executable, '-c', CHILD, os.path.abspath(root), str(steps),
         str(reps), kinds], capture_output=True, text=True, timeout=timeout,
        cwd=os.path.abspath(root))
    if out.returncode != 0:
        raise RuntimeError(f'{root} failed:\n{out.stderr[-4000:]}')
    for line in out.stdout.splitlines():
        if line.startswith('RESULT '):
            return json.loads(line[len('RESULT '):])
        print(line, flush=True)
    raise RuntimeError(f'{root} printed no result')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('a', help='checkout A (e.g. the parent commit)')
    ap.add_argument('b', help='checkout B (e.g. the change)')
    ap.add_argument('--out', default=None)
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--kinds', default='plain,nominal',
                    help="comma-separated: plain, nominal, batched")
    args = ap.parse_args()
    runs = []
    for tag, root in (('A', args.a), ('B', args.b), ('B', args.b),
                      ('A', args.a)):
        res = run_checkout(root, args.steps, args.reps, args.kinds)
        runs.append(dict(tag=tag, root=root, episodes=res))
        print(f'run {len(runs)} ({tag}): ' + '; '.join(
            f'{kind} first episode {r["walls_s"][0]:.4f} s, later episodes '
            f'median {float(np.median(r["walls_s"][1:])):.4f} s '
            f'({float(np.median(r["walls_s"][1:])) / args.steps:.5f} s a '
            f'step), kernel nodes of the kept programs {r["nodes"]}, '
            + (f'kept programs {r["program_bytes"]} bytes, '
               if 'program_bytes' in r else '')
            + f'iterations {r["iters"] if kind != "batched" else "(lanes)"}'
            for kind, r in res.items()), flush=True)
    # The two checkouts sum in other orders: how far their episodes' states
    # lie apart, and whether each checkout repeats itself to the bit.
    diff, same = {}, {}
    for kind in runs[0]['episodes']:
        st = {t: [np.asarray(r['episodes'][kind]['states']) for r in runs
                  if r['tag'] == t] for t in 'AB'}
        diff[kind] = float(np.abs(st['A'][0] - st['B'][0]).max())
        same[kind] = {t: all(np.array_equal(x, v[0]) for x in v)
                      for t, v in st.items()}
    print(f'states, max |A - B|: {diff}; each checkout the same bits in '
          f'both its runs: {same}', flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'compare_episode.json'), 'w') as f:
            json.dump(dict(runs=runs, states_max_abs_diff=diff,
                           same_bits=same, steps=args.steps,
                           reps=args.reps), f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
