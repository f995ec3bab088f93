"""gpmpc_tpu_torch: the PyTorch and CUDA port of gpmpc_tpu.

Risk-sensitive Gaussian-Process MPC on an NVIDIA GPU. The package mirrors
`gpmpc_tpu/` path for path; `gpmpc_tpu/` stays the reference the port is
checked against, and this package imports none of it (nor JAX).

Ported: everything the JAX package does. The batched solve on the headline problem (`solve_batch`,
fused branch) with its chain: the padded exact GP and its f64 fit, the
moment-matched rollout with a diagonal or a full covariance (batched, and
the single-scenario `rollout` with the nominal-model terms), the
risk-sensitive cost and the lockstep projected L-BFGS; the multistart
recipes on top of it
(`solve_batch_multistart`, the production `solve_batch_multistart_retired`
with `problems.RECIPE` and `REFINE`) and `solve_batch_staged`; the fan-out over torch.distributed
(parallel/mesh, parallel/distributed, `solve_batch_sharded`) and the
model-sharded solve `parallel.model_sharded.solve_batch_2d`; and the online
learn-and-control loop: the GP's append, grow, set_hyperparams and eigh
backend, marginal-likelihood training (gp/train.py), the single-scenario
solver (`solve_trajectory`, L-BFGS and Adam), the `RiskSensitiveMPC`
controller, the pendulum and cartpole plants, the analytic pendulum models,
the `Simulator` and `run_episode_on_device`, and the experiments
(`python -m gpmpc_tpu_torch.experiments.<name>`); the FITC sparse GP
(gp/sparse.py), which the batched solves run through the same kernels, the
per-scenario routes (`solve_batch(impl='vmap')`, `solve_batch_gp` over
`stack_gps` draws: one lockstep solve, `solve_trajectory_batched`, of
every lane's single-scenario rollout, `rollout_lanes`, by L-BFGS or
projected Adam),
the augmented-Lagrangian `mpc.constrained`, the
reference's class facades (`compat`), checkpoints and metrics (utils/), the
native box solver (`native`, built from native/box_solver.cpp) and the
episode renderers (sim/render.py). The variance
trace runs through hand-written CUDA kernels (ops/kernels/csrc): the column
sweep, its row block for model sharding, and the symmetric-pair kernel behind
the GPMPC_SYM_KERNEL=1 opt-in; it is evaluated in f64 whatever the problem's
dtype, since it cancels (ops/kernels/variance_trace.py). The probes of the column sweep's time
(ops/kernels/probe.py, run by benchmarks/kernel_ablate and kernel_probe)
instantiate its body under variants. Entry points run on CUDA unless the
caller passes device='cpu'.
"""

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.gp.state import GPConfig, GPState, append, make_gp
from gpmpc_tpu_torch.gp.exact import predict, log_marginal_likelihood
from gpmpc_tpu_torch.gp.train import train_hyperparams
from gpmpc_tpu_torch.gp.sparse import fit_sparse
from gpmpc_tpu_torch.dynamics import (RolloutCache, build_rollout_cache,
                                      rollout, rollout_batched,
                                      rollout_from_gp, rollout_lanes)
from gpmpc_tpu_torch.mpc.cost import CostParams, risk_sensitive_cost
from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
from gpmpc_tpu_torch.mpc.solver import (SolverConfig, solve_trajectory,
                                        solve_trajectory_batched)
from gpmpc_tpu_torch.parallel.batch import (solve_batch, solve_batch_gp,
                                             solve_batch_multistart,
                                             solve_batch_multistart_retired,
                                             solve_batch_staged, stack_gps)
from gpmpc_tpu_torch.problems import RECIPE, REFINE, make_headline_problem
from gpmpc_tpu_torch.sim.simulator import Simulator, run_episode_on_device

__version__ = "0.1.0"
