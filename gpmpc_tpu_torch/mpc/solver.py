"""Box-constrained trajectory solvers (port of gpmpc_tpu/mpc/solver.py).

`solve_trajectory_batched`: a lockstep solve of B independent problems by
config.method, projected L-BFGS (below) or projected Adam. Every lane has its own acceptance, step size, history and
convergence; lanes that are done freeze while the loop runs on until all are
done or the iteration cap. One iteration is `_lbfgs_step`, a function of the
carry `LbfgsState`. JAX's `lax.while_loop` compiles the loop into one
program on the device, and jax.jit keeps that program for every later call
of the same shapes. What runs each iteration depends on where it runs. On
CUDA, with the objective's own autograd (`solve_batch` with a diagonal or a
full covariance, the per-scenario routes, the multistart recipes,
`solve_batch_staged`, the controller's routes and the single-scenario
episode of `run_episode_on_device`), the solve is a *program*
(`_run_graphed`): the call that builds it runs the first value-and-grad and
iteration 1 eagerly and captures two CUDA graphs, the init and the step;
the program is kept in a cache keyed by what the captured code reads, and a
later call of the same key captures nothing. Its loop runs on the device
(`loop_form()` 'while': ops/kernels/loop_cond.py's loop graph, the step
captured into the body of a conditional WHILE node that runs it while
t < max_iters and a lane is live, read on the device): a call is its init
graph, one loop launch and its polish graph, and reads nothing on the host
until the caller reads the result, as JAX's jitted while_loop. Where the
card's CUDA is older than 12.4 (`loop_form()` 'host'), and inside
`_host_read_loop()` (the reference), the host replays the step graph and
reads `all(done)` once an iteration (`_go_on`), the iteration count the
same. An
objective given as an `Objective` (key, inputs, build), or an external
value-and-grad given as a `ValueAndGrad` (the model-sharded solve's, with
its collectives inside), has its program kept; a plain closure gets one
for its call only. A program whose value-and-grad runs collectives is
captured where the group's backend puts them on the card's streams (NCCL,
`CAPTURED_BACKENDS`), and its life is bound to the group
(`release_group_programs`). On the CPU, with a bare external
value-and-grad or a group whose collectives go through the host (gloo),
and where the caller says `_graph=False` (`solve_trajectory`), each
iteration runs its torch ops from Python (`_run_eager`) and the host reads
`all(done)` once an iteration. All run the same kernels on the same
inputs, so the same bits.

Projected Adam (method='adam') takes a fixed step and an optional polish of
normalized-gradient steps, with JAX's vmapped-while semantics: a lane's carry freezes once its
projected-gradient residual is below tol, the loop runs until every lane is
done or the cap, and iterations, the polish's max|g|, the final cost and
pg_norm are per lane. Both methods run through the same machinery (a
method is an (init, step, polish) triple, `_METHODS`), programs included.

`solve_trajectory`: one solve of objective(u) -> scalar, the lockstep
solver of its method at B = 1 (JAX's single-scenario L-BFGS and Adam are the
same recurrences lane for lane), its loop run eagerly: it takes any
closure, and one that reads a value on the host cannot be captured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Hashable, NamedTuple, Optional

import torch

from gpmpc_tpu_torch.ops.kernels import loop_cond
from gpmpc_tpu_torch.utils import replay_counts

@dataclass(frozen=True)
class SolverConfig:
    # 'lbfgs': projected L-BFGS with a projected-Armijo step; 'adam':
    # projected Adam with a fixed step (solve_trajectory only).
    method: str = 'lbfgs'
    max_iters: int = 300
    tol: float = 1e-4
    # Adam options.
    learning_rate: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # L-BFGS history length.
    history: int = 8
    # Kept for the JAX config's field set; the single-candidate Armijo step
    # has no inner backtracking loop.
    max_backtracks: int = 20
    # Nonmonotone Armijo window (accept against the max of the last
    # `nonmonotone` accepted values); 0 = monotone.
    nonmonotone: int = 0
    # Relative objective noise for the noise-tolerant Armijo test; with
    # noise_rel > 0 a lane is done after `progress_window` iterations without
    # improvement beyond the noise, and the best iterate is returned.
    noise_rel: float = 0.0
    progress_window: int = 12
    # Projected steps along the normalized gradient after the main loop, the
    # step decaying by 2^(-1/4) each (Adam).
    polish_iters: int = 0

    def replace(self, **changes) -> 'SolverConfig':
        """A copy with `changes` applied (the JAX struct's `.replace`)."""
        return dataclasses.replace(self, **changes)


class SolveResult(NamedTuple):
    u: torch.Tensor          # (B, H, da); (H, da) from solve_trajectory
    cost: torch.Tensor       # (B,) or ()
    iters: torch.Tensor      # (B,) iterations each lane took, or ()
    pg_norm: torch.Tensor    # (B,) projected-gradient residual (inf-norm)
    # (B,) done before the cap; None from the Adam solver, as in JAX.
    converged: Optional[torch.Tensor] = None


def first_lane(res: SolveResult) -> SolveResult:
    """Lane 0 of a batched result, shaped as a single solve's (converged
    stays None where it is)."""
    return SolveResult(*(None if t is None else t[0] for t in res))


def _value_and_grad(objective_b, u_flat, shape):
    """f (B,) and its per-lane gradient (B, n): lanes are independent, so the
    gradient of the sum is the stack of the per-lane gradients."""
    u_var = u_flat.detach().requires_grad_(True)
    with torch.enable_grad():
        f = objective_b(u_var.reshape(shape))
        (g,) = torch.autograd.grad(f.sum(), u_var)
    return f.detach(), g


def _bdot(x, y):
    return torch.einsum('bn,bn->b', x, y)


class LbfgsState(NamedTuple):
    """The lockstep loop's carry, every field a tensor on the solve's
    device (B lanes, n = H * da): the iterate u (B, n), its value f (B,)
    and gradient g (B, n), the accepted values of the nonmonotone window
    fhist (B, max(nonmonotone, 1)), the step sizes t_ls (B,), the L-BFGS
    memory s_h, y_h (B, history, n), rho_h (B, history) and its length hlen
    (B,), the restarts taken, the best iterate f_best, u_best and the
    iterations without progress no_prog (noise_rel > 0), each lane's
    iterations iters_b and stop done, and the iteration index t (an int64
    scalar: a captured step reads it on the device)."""
    u: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    fhist: torch.Tensor
    t_ls: torch.Tensor
    s_h: torch.Tensor
    y_h: torch.Tensor
    rho_h: torch.Tensor
    hlen: torch.Tensor
    resets: torch.Tensor
    f_best: torch.Tensor
    u_best: torch.Tensor
    no_prog: torch.Tensor
    iters_b: torch.Tensor
    done: torch.Tensor
    t: torch.Tensor


class _Problem(NamedTuple):
    """What an iteration reads and never writes: val_and_grad(u (B, n)) ->
    (f (B,), g (B, n)), the box lb, ub (B, n), a zero of u's dtype and the
    config."""
    val_and_grad: Callable
    lb: torch.Tensor
    ub: torch.Tensor
    zero: torch.Tensor
    config: SolverConfig
    # What the program cache keeps the solve under (`_run_graphed`), or
    # None (a closure, or an eager solve): (key, inputs, build), where
    # build(*inputs) gives a val_and_grad.
    program: Optional[tuple] = None
    # The method (a key of _METHODS) whose init, step and polish run.
    method: str = 'lbfgs'
    # The process group whose collectives val_and_grad runs, or None.
    group: Optional[object] = None


def _proj(p: _Problem, u):
    return torch.minimum(torch.maximum(u, p.lb), p.ub)


def _pg_res(p: _Problem, u, g):                        # (B,)
    return torch.amax(torch.abs(u - _proj(p, u - g)), dim=1)


def _two_loop(p: _Problem, g, s_h, y_h, rho_h, hlen):
    mem = p.config.history
    q = g
    alphas = [None] * mem
    for k in range(mem - 1, -1, -1):
        valid = k >= mem - hlen                        # (B,)
        a = torch.where(valid, rho_h[:, k] * _bdot(s_h[:, k], q), p.zero)
        alphas[k] = a
        q = q - a[:, None] * y_h[:, k]
    sy = _bdot(s_h[:, mem - 1], y_h[:, mem - 1])
    yy = _bdot(y_h[:, mem - 1], y_h[:, mem - 1])
    scale = torch.where((hlen > 0) & (yy > 0.0),
                        sy / torch.clamp(yy, min=1e-30),
                        torch.ones_like(sy))
    r = scale[:, None] * q
    for k in range(mem):
        valid = k >= mem - hlen
        bk = torch.where(valid, rho_h[:, k] * _bdot(y_h[:, k], r), p.zero)
        r = r + (alphas[k] - bk)[:, None] * s_h[:, k]
    return r


def _lbfgs_init(p: _Problem, u_init) -> LbfgsState:
    """The carry before the first iteration: u_init (B, n) projected onto
    the box, one value-and-grad there, empty memory."""
    b, n = u_init.shape
    dt, dev = u_init.dtype, u_init.device
    mem = p.config.history
    u = _proj(p, u_init)
    f, g = p.val_and_grad(u)
    g = torch.where(torch.isfinite(g), g, p.zero)
    hlen = torch.zeros((b,), dtype=torch.long, device=dev)
    s_h = torch.zeros((b, mem, n), dtype=dt, device=dev)
    return LbfgsState(
        u=u, f=f, g=g,
        fhist=f[:, None].expand(b, max(p.config.nonmonotone, 1)).clone(),
        t_ls=torch.ones((b,), dtype=dt, device=dev), s_h=s_h,
        y_h=torch.zeros_like(s_h),
        rho_h=torch.zeros((b, mem), dtype=dt, device=dev), hlen=hlen,
        resets=torch.zeros_like(hlen), f_best=f, u_best=u,
        no_prog=torch.zeros_like(hlen), iters_b=torch.zeros_like(hlen),
        done=torch.zeros((b,), dtype=torch.bool, device=dev),
        t=torch.zeros((), dtype=torch.long, device=dev))


def _lbfgs_step(p: _Problem, s: LbfgsState) -> LbfgsState:
    """One lockstep iteration: one value-and-grad at each lane's candidate
    and every lane's update; lanes already done keep every field, so a state
    with every lane done is a fixed point. Reads no value on the host, so
    that it can be captured in a CUDA graph; a field it does not change
    comes back as the same tensor."""
    cfg = p.config
    mem = cfg.history
    nm = cfg.nonmonotone
    noise = cfg.noise_rel
    eps_scale = ((2.0 * noise) if noise > 0.0
                 else 16.0 * torch.finfo(s.u.dtype).eps)
    u, f, g, done = s.u, s.f, s.g, s.done
    t_ls, hlen = s.t_ls, s.hlen
    live = ~done
    # Two-metric projection: the quasi-Newton direction sees only the
    # FREE gradient; bound-active coordinates take plain gradient steps.
    eps_act = 1e-6 * (1.0 + torch.abs(u))
    act = (((u <= p.lb + eps_act) & (g > 0.0))
           | ((u >= p.ub - eps_act) & (g < 0.0)))
    d = -_two_loop(p, torch.where(act, p.zero, g), s.s_h, s.y_h, s.rho_h,
                   hlen)
    d = torch.where(act, -g, d)
    d = torch.where((_bdot(g, d) < -1e-16)[:, None], d, -g)

    # ONE value_and_grad per iteration, at the candidate: on acceptance its
    # gradient is the next iterate's; on rejection the carried (u, f, g)
    # stay valid.
    c1 = 1e-4
    u_try = _proj(p, u + t_ls[:, None] * d)
    f_try, g_try = p.val_and_grad(u_try)
    dec = _bdot(g, u_try - u)
    f_acc = f if nm == 0 else torch.amax(s.fhist, dim=1)
    eps_f = eps_scale * (1.0 + torch.abs(f))
    accepted = ((f_try <= f_acc + c1 * dec + eps_f) & (dec < 0.0)
                & torch.isfinite(f_try) & live)
    u_new = torch.where(accepted[:, None], u_try, u)
    f_new = torch.where(accepted, f_try, f)
    fhist = s.fhist
    if nm > 0:
        fhist = torch.where(accepted[:, None],
                            torch.cat([fhist[:, 1:], f_new[:, None]], 1),
                            fhist)
    # Step size: growth capped at 4; rejection backtracks by quadratic
    # interpolation of phi(t) = f(proj(u + t d)), clamped to [0.1, 0.5] t.
    denom = f_try - f - dec
    pos = denom > 0.0
    t_q = torch.where(pos, t_ls * (-0.5 * dec)
                      / torch.where(pos, denom, torch.ones_like(denom)),
                      0.5 * t_ls)
    t_down = torch.minimum(torch.maximum(t_q, 0.1 * t_ls), 0.5 * t_ls)
    t_ls = torch.where(done, t_ls,
                       torch.where(accepted,
                                   torch.clamp(2.0 * t_ls, max=4.0),
                                   t_down))

    g_try = torch.where(torch.isfinite(g_try), g_try, p.zero)
    g_new = torch.where(accepted[:, None], g_try, g)

    sv = u_new - u
    y = g_new - g
    sy = _bdot(sv, y)
    # Cosine curvature gate: noise-dominated (s, y) pairs stay out.
    sy_ok = sy > torch.clamp(
        1e-8 * torch.linalg.vector_norm(sv, dim=1)
        * torch.linalg.vector_norm(y, dim=1), min=1e-12)
    keep = accepted & sy_ok
    s_h = torch.where(keep[:, None, None],
                      torch.cat([s.s_h[:, 1:], sv[:, None]], 1), s.s_h)
    y_h = torch.where(keep[:, None, None],
                      torch.cat([s.y_h[:, 1:], y[:, None]], 1), s.y_h)
    rho_h = torch.where(
        keep[:, None],
        torch.cat([s.rho_h[:, 1:],
                   (1.0 / torch.clamp(sy, min=1e-30))[:, None]], 1), s.rho_h)
    hlen = torch.where(keep, torch.clamp(hlen + 1, max=mem), hlen)

    # Step underflow: restart from steepest descent (at most twice); a
    # repeated underflow declares the lane stationary.
    underflow = t_ls < 1e-10
    restart = live & underflow & (s.resets < 2)
    hlen = torch.where(restart, torch.zeros_like(hlen), hlen)
    t_ls = torch.where(restart, torch.ones_like(t_ls), t_ls)
    resets = torch.where(restart, s.resets + 1, s.resets)
    newly_done = (_pg_res(p, u_new, g_new) < cfg.tol) | (underflow & ~restart)
    f_best, u_best, no_prog = s.f_best, s.u_best, s.no_prog
    if noise > 0.0:
        improved = f_new < f_best - noise * (1.0 + torch.abs(f_best))
        u_best = torch.where((f_new < f_best)[:, None], u_new, u_best)
        f_best = torch.where(done, f_best, torch.minimum(f_best, f_new))
        no_prog = torch.where(done, no_prog,
                              torch.where(improved, torch.zeros_like(no_prog),
                                          no_prog + 1))
        newly_done = newly_done | (no_prog >= cfg.progress_window)
    # An iteration counts where a lane was live (the loop runs only then).
    t = s.t + live.any()
    return LbfgsState(
        u=u_new, f=f_new, g=g_new, fhist=fhist, t_ls=t_ls, s_h=s_h, y_h=y_h,
        rho_h=rho_h, hlen=hlen, resets=resets, f_best=f_best, u_best=u_best,
        no_prog=no_prog, iters_b=torch.where(done, s.iters_b, t),
        done=done | (newly_done & live), t=t)


class AdamState(NamedTuple):
    """Projected Adam's lockstep carry (B lanes, n = H * da): the iterate u
    (B, n), its value f (B,) and gradient g (B, n) as the value-and-grad
    gives it (the steps read it with non-finite entries as 0; the result's
    pg_norm reads it as it is, as JAX's does), the moments m, v (B, n),
    each lane's iterations iters_b (its own Adam step count) and stop done,
    the loop's iteration index t and the polish steps taken i_pol (int64
    scalars)."""
    u: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    iters_b: torch.Tensor
    done: torch.Tensor
    t: torch.Tensor
    i_pol: torch.Tensor


def _finite(p: _Problem, g):
    return torch.where(torch.isfinite(g), g, p.zero)


def _adam_init(p: _Problem, u_init) -> AdamState:
    """u_init (B, n) projected onto the box, one value-and-grad there, zero
    moments."""
    b = u_init.shape[0]
    u = _proj(p, u_init)
    f, g = p.val_and_grad(u)
    zero = torch.zeros((), dtype=torch.long, device=u.device)
    return AdamState(u=u, f=f, g=g, m=torch.zeros_like(u),
                     v=torch.zeros_like(u),
                     iters_b=torch.zeros((b,), dtype=torch.long,
                                         device=u.device),
                     done=torch.zeros((b,), dtype=torch.bool, device=u.device),
                     t=zero, i_pol=zero.clone())


def _adam_step(p: _Problem, s: AdamState) -> AdamState:
    """One lockstep Adam iteration, JAX's body on every live lane: the
    moments, the bias correction at the lane's own step count, the projected
    step, one value-and-grad; a lane is done once its residual is below
    tol, and a done lane keeps every field (vmapped-while semantics). Reads
    no value on the host."""
    cfg = p.config
    live = ~s.done
    g = _finite(p, s.g)
    m = cfg.b1 * s.m + (1.0 - cfg.b1) * g
    v = cfg.b2 * s.v + (1.0 - cfg.b2) * g * g
    t1 = s.iters_b + 1
    tf = t1.to(s.u.dtype)[:, None]
    mhat = m / (1.0 - torch.pow(cfg.b1, tf))
    vhat = v / (1.0 - torch.pow(cfg.b2, tf))
    u_new = _proj(p, s.u - cfg.learning_rate * mhat
                  / (torch.sqrt(vhat) + cfg.eps))
    f_new, g_new = p.val_and_grad(u_new)
    done = _pg_res(p, u_new, _finite(p, g_new)) < cfg.tol
    keep = live[:, None]
    return s._replace(
        u=torch.where(keep, u_new, s.u), f=torch.where(live, f_new, s.f),
        g=torch.where(keep, g_new, s.g), m=torch.where(keep, m, s.m),
        v=torch.where(keep, v, s.v), iters_b=torch.where(live, t1, s.iters_b),
        done=torch.where(live, done, s.done), t=s.t + live.any())


def _adam_polish(p: _Problem, s: AdamState) -> AdamState:
    """Polish step i_pol on every lane: u moves by lr 2^(-i/4) g /
    (max|g| + eps) (the lane's own max|g|, g read with non-finite entries
    as 0) and is projected, then one value-and-grad at the new u. The
    carried g is the gradient at u, so after `polish_iters` steps f and g
    are the final cost and gradient that JAX evaluates afresh."""
    cfg = p.config
    g = _finite(p, s.g)
    step = cfg.learning_rate * torch.pow(0.5, s.i_pol.to(s.u.dtype) / 4.0)
    u = _proj(p, s.u - step * g / (torch.amax(torch.abs(g), dim=1,
                                              keepdim=True) + cfg.eps))
    f, g_new = p.val_and_grad(u)
    return s._replace(u=u, f=f, g=g_new, i_pol=s.i_pol + 1)


class _Method(NamedTuple):
    """A lockstep solver: init(p, u0 (B, n)) -> state and step(p, state) ->
    state (a state with every lane done is a fixed point) for the loop,
    and polish(p, state) -> state, run config.polish_iters times after it
    (None: no polish). Each reads nothing on the host, so that a program
    can capture it."""
    init: Callable
    step: Callable
    polish: Optional[Callable] = None


_METHODS = {'lbfgs': _Method(_lbfgs_init, _lbfgs_step),
            'adam': _Method(_adam_init, _adam_step, _adam_polish)}


def _polish_iters(p: _Problem) -> int:
    """The polish steps p's solve takes after its loop."""
    return p.config.polish_iters if _METHODS[p.method].polish else 0


def _go_on(s: LbfgsState, t: int, max_iters: int) -> bool:
    """The host-read loop's condition, JAX's while_loop cond: below the cap
    and a lane not done (one read on the host an iteration, counted in
    utils/replay_counts.HOST_READS). Its device form is
    ops/kernels/loop_cond.go_on."""
    if t >= max_iters:
        return False
    replay_counts.host_read()
    return not bool(s.done.all())


def _loop_from(p: _Problem, s: LbfgsState, t: int, step) -> LbfgsState:
    """The rest of the loop from iteration t: step() runs one iteration."""
    while _go_on(s, t, p.config.max_iters):
        s = step(s)
        t += 1
    return s


def _run_eager(p: _Problem, u0):
    """The loop of p's method from u0 (B, n), its first value-and-grad and
    its polish steps included, every iteration's torch ops run from
    Python."""
    m = _METHODS[p.method]
    s = _loop_from(p, m.init(p, u0), 0, lambda s: m.step(p, s))
    for _ in range(_polish_iters(p)):
        s = m.polish(p, s)
    return s


def _step_in_place(p: _Problem, s) -> None:
    """One step of p's method written back into s's own tensors (`copy_`),
    which must not alias one another: the code a capture records."""
    _write(s, _METHODS[p.method].step(p, s))


def _init_in_place(p: _Problem, u0, s) -> None:
    """The init of p's method from u0 written into s's own tensors: the
    code of a program's init graph (L-BFGS's f_best and u_best are copies,
    not aliases, of f and u)."""
    _write(s, _METHODS[p.method].init(p, u0))


def _polish_in_place(p: _Problem, s) -> None:
    """One polish step of p's method written into s's own tensors: the
    code of a program's polish graph."""
    _write(s, _METHODS[p.method].polish(p, s))


def _write(dst, src) -> None:
    for d, v in zip(dst, src):
        if v is not d:
            d.copy_(v)


def _capture(record: Callable[[LbfgsState], None], s: LbfgsState,
             pool=None, loop_iters: Optional[int] = None):
    """A CUDA graph of record(s), which writes the static buffers s in
    place, on the current stream (a side stream that has run the code
    eagerly: its lazy initialisation is done), into the memory pool `pool`
    (a new one if None). Capture records and runs nothing. With
    `loop_iters` (the device loop) the graph is a loop_cond.DeviceLoop:
    record(s) captured straight into the body of a WHILE node that runs it
    while s.t < loop_iters and a lane of s.done is live; else a
    torch.cuda.CUDAGraph. Returns the graph, instantiated, and its counts
    (utils/replay_counts.Replays: the kernel launches of a pass or replay
    read from the graph's nodes). Code that waits on the host raises
    here."""
    before = replay_counts.snapshot()
    if loop_iters is not None:
        graph = loop_cond.DeviceLoop(lambda: record(s), s.t, s.done,
                                     loop_iters, pool)
        nodes = graph.body
    else:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=pool)
        try:
            record(s)
        except BaseException:
            # The capture is broken already: end it, and raise the cause.
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
        nodes = graph.raw_cuda_graph()
    counts = replay_counts.Replays(before, replay_counts.snapshot(),
                                   replay_counts.graph_kernel_names(nodes))
    if loop_iters is None:
        graph.instantiate()
    return graph, counts


# ------------------------------------------------------------- programs --
# A program is the port's counterpart of one entry of jax.jit's cache: the
# captured solve of one objective at one shape by one method, kept and
# replayed on every later call with the same key. It owns static copies of
# the objective's input tensors, of u_init, lb and ub, the objective built
# once on those copies, a static state of its method (LbfgsState,
# AdamState), its CUDA graphs (`_init_in_place`, `_step_in_place` and, for
# a solve with polish steps, `_polish_in_place`) with their counts, a side
# stream and a memory pool. On the device loop the step is captured into the
# body of the loop graph (loop_cond.DeviceLoop), which is the only copy of
# it; on the host-read loop it is a graph of its own.
#
# A call copies its inputs into the program's buffers, replays the init
# graph, launches the loop (the device loop: one launch of the loop graph,
# whose WHILE node runs the step; the host-read loop: the step graph once an
# iteration while `_go_on` holds), replays the polish graph once a polish
# step, and copies the result out on the caller's stream: no result is a
# view of a program's buffer, and the device loop reads nothing on the
# host. Programs stay, least recently used first, while the cache holds at
# most MAX_PROGRAM_BYTES (their pools' reserved bytes, measured around the
# captures, and their static buffers): a third of an H100's 80 GB, which
# holds the recipe's six programs (~1.0 GB) or thirteen full-covariance
# headline ones (~1.8 GB each) (PERF.md).
# `clear_programs()` (jax.clear_caches()) drops them all. A program replays
# the code its capture recorded: a block that swaps a function the
# objective calls (a diagnostic trace, a counting wrapper) is in no key, so
# it drops the programs first.
MAX_PROGRAM_BYTES = 24 * 2 ** 30
_PROGRAMS: 'OrderedDict[Hashable, _Program]' = OrderedDict()
# Set only inside `_host_read_loop()`.
_host_read = False


def loop_form() -> str:
    """The loop of a kept program on this card: 'while' (the device loop,
    CUDA 12.4 or later) or 'host' (the host-read loop), chosen by version
    (loop_cond.supported, read once). A loop graph that fails to build or
    launch raises, and never turns into the host-read loop."""
    return 'while' if loop_cond.supported() else 'host'


@contextlib.contextmanager
def _host_read_loop():
    """Programs built and run in the block take the host-read loop (the
    step graph replayed once an iteration while the host reads all(done)):
    the reference the device loop is held to, and the loop a profiler can
    trace. The loop is in a program's key, so these programs are kept
    beside the device loop's."""
    global _host_read
    was, _host_read = _host_read, True
    try:
        yield
    finally:
        _host_read = was


def _loop_of(device) -> str:
    """The loop a program on `device` runs: 'while' on CUDA where
    loop_form() is and outside `_host_read_loop()`, else 'host' (the CPU,
    where tests stand graphs in, included)."""
    if device.type == 'cuda' and not _host_read and loop_form() == 'while':
        return 'while'
    return 'host'


# The backends whose collectives a kept program captures, by device type.
# NCCL runs its collectives as work on the card's streams, which a capture
# records; gloo moves a CUDA tensor through the host, which no capture can
# record. A solve over a group of another backend runs its loop eagerly.
CAPTURED_BACKENDS = {'cuda': ('nccl',)}


def _collectives_captured(group, device) -> bool:
    """Whether a program on `device` may capture the collectives of
    `group` (None: a value-and-grad that runs none): the group's backend
    is one of CAPTURED_BACKENDS for the device's type. A rule fixed in
    advance, never a capture tried and caught."""
    if group is None:
        return True
    import torch.distributed as dist
    return dist.get_backend(group) in CAPTURED_BACKENDS.get(device.type, ())


# A serial number for each process group a program is built over, never
# reused in the process: a program's key holds it, so a new group (a new
# initialize()) never finds a program of a group destroyed before it. A
# program holds its group, so the group's entry lives as long as it does.
_GROUP_SERIALS: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()
_NEXT_SERIAL = itertools.count(1)


def _group_key(group) -> Hashable:
    """What names `group` in a program's key: its backend, size, this
    process's rank in it and its serial number (None without a group)."""
    if group is None:
        return None
    import torch.distributed as dist
    if group not in _GROUP_SERIALS:
        _GROUP_SERIALS[group] = next(_NEXT_SERIAL)
    return (dist.get_backend(group), group.size(), group.rank(),
            _GROUP_SERIALS[group])


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _clone(s):
    """A state whose every field is a tensor of its own."""
    return type(s)(*(x.clone() for x in s))


class _Program:
    """One solve's captured program (see above). Built by the call that
    misses: the call runs its first value-and-grad and iteration 1 eagerly
    on the program's buffers (the warm-up a capture needs; a state with
    every lane done is a fixed point of the step, so iteration 1 runs
    whatever the init left where max_iters > 0, and reads nothing on the
    host), captures the step (on the device loop, into its loop graph) and,
    if `keep`, the init, and runs the rest of the loop; a solve with polish
    steps runs one eagerly on a copy (its warm-up), captures it and replays
    it once a polish step. `state` is the static state a call leaves its
    result in. A device loop's passes are summed on the device (`passes`)
    and counted by `settle()` (utils/replay_counts.watch)."""

    def __init__(self, p: _Problem, u0, main, keep: bool):
        dev = u0.device
        method = _METHODS[p.method]
        self.side = torch.cuda.Stream(device=dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.polish = None
        self.side.wait_stream(main)
        with torch.cuda.device(dev), torch.cuda.stream(self.side):
            if p.program is None:
                self.inputs, vg = (), p.val_and_grad
            else:
                _, inputs, build = p.program
                # empty_like keeps a dense input's strides (they are in the
                # key); copy_ fills it.
                self.inputs = tuple(None if x is None
                                    else torch.empty_like(x).copy_(x)
                                    for x in inputs)
                vg = build(*self.inputs)
            self.u0 = u0.clone()
            self.p = p._replace(val_and_grad=vg, lb=p.lb.clone(),
                                ub=p.ub.clone(), zero=p.zero.clone(),
                                program=None)
            s = method.init(self.p, self.u0)
            t = min(1, p.config.max_iters)
            if t:
                s = method.step(self.p, s)
            # Distinct buffers: a field may alias another (f_best is f
            # until the noise mode moves it).
            self.state = s = _clone(s)
            self.pool_bytes = 0
            device_loop = _loop_of(dev) == 'while'
            self.step, self.step_counts = self._capture(
                lambda st: _step_in_place(self.p, st), s, dev,
                loop_iters=p.config.max_iters if device_loop else None)
            self.graphs.append(self.step)
            self.loop = self.step if device_loop else None
            if device_loop:
                self.passes = torch.zeros((), dtype=torch.long, device=dev)
                self.launched = 0
                replay_counts.watch(self)
            if keep:
                self.init, self.init_counts = self._capture(
                    lambda st: _init_in_place(self.p, self.u0, st), s, dev)
                self.graphs.append(self.init)
            self._loop(s, t)
            if _polish_iters(self.p):
                method.polish(self.p, _clone(s))
                self.polish, self.polish_counts = self._capture(
                    lambda st: _polish_in_place(self.p, st), s, dev)
                self.graphs.append(self.polish)
                self._replay_polish()
        self.bytes = self.pool_bytes + _nbytes(
            (*self.inputs, self.u0, self.p.lb, self.p.ub, self.p.zero, *s))

    def _capture(self, record, s, dev, loop_iters=None):
        """`_capture` into the program's pool, after freeing the
        allocator's cached blocks: a capture cannot free them (no cudaFree
        while a stream captures), so blocks cached by earlier work, by the
        eager warm-up or by released programs' pools would stay out of
        this pool's reach, and a capture of ~12 GB (the lanes routes at
        256 lanes) runs out of memory behind them. Adds the pool's growth,
        all that a capture allocates, to pool_bytes."""
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        out = _capture(record, s, self.pool, loop_iters=loop_iters)
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        return out

    def _loop(self, s, t: int) -> None:
        """The rest of the loop from s, whose iteration index is t: one
        launch of the loop graph, or the host-read loop."""
        if self.loop is None:
            self._replay_steps(s, t)
            return
        # The passes it runs (t after less t before), summed on the device.
        self.passes.sub_(s.t)
        self.loop.launch()
        self.passes.add_(s.t)
        self.launched += 1

    def settle(self) -> None:
        """Count the passes the device loop ran since the last settle, in
        the step's counts, and the condition kernel's launches (one a loop
        launch, one a pass). Waits for the program's stream."""
        if not self.launched:
            return
        with torch.cuda.stream(self.side):
            n = int(self.passes)
            self.passes.zero_()
        launched, self.launched = self.launched, 0
        self.step_counts.replayed(n)
        loop_cond.add_launches(launched + n)

    def _replay_steps(self, s, t) -> None:
        def step(st):
            self.step.replay()
            self.step_counts.replayed()
            return st
        _loop_from(self.p, s, t, step)

    def _replay_polish(self) -> None:
        for _ in range(_polish_iters(self.p)):
            self.polish.replay()
            self.polish_counts.replayed()

    def run(self, p: _Problem, u0, main) -> None:
        """A later call: this call's inputs, u0, lb and ub into the
        program's buffers, the init graph, then the loop, then the polish
        graph once a polish step."""
        self.side.wait_stream(main)
        with torch.cuda.device(u0.device), torch.cuda.stream(self.side):
            for dst, src in zip(self.inputs, p.program[1]):
                if dst is not None:
                    dst.copy_(src)
            self.u0.copy_(u0)
            self.p.lb.copy_(p.lb)
            self.p.ub.copy_(p.ub)
            self.init.replay()
            self.init_counts.replayed()
            self._loop(self.state, 0)
            self._replay_polish()

    def release(self) -> None:
        """Its device loop counted, then its graphs and their pool go
        (after its last work ends)."""
        self.side.synchronize()
        if self.loop is not None:
            self.settle()
            self.loop = None
        for g in self.graphs:
            g.reset()
        self.graphs = []


def _program_key(p: _Problem, u0) -> Hashable:
    """The key of p's program: the caller's key and the method, each
    input's shape, strides, dtype and device, u0's, lb's and ub's broadcast
    shapes (in p.program's key), the solver config, the K4 opt-in that
    the trace reads on every call (ops/kernels/variance_trace.py), the
    process group of its collectives (`_group_key`) and, last, the loop
    (`_loop_of`)."""
    key, inputs, _ = p.program
    sig = tuple(None if x is None else (tuple(x.shape), x.stride(), x.dtype,
                                        x.device) for x in inputs)
    return ((p.method, *key), sig, tuple(u0.shape), u0.dtype, u0.device,
            p.config, os.environ.get('GPMPC_SYM_KERNEL'), _group_key(p.group),
            _loop_of(u0.device))


def clear_programs() -> None:
    """Drop every kept program (the counterpart of jax.clear_caches())."""
    while _PROGRAMS:
        _PROGRAMS.popitem(last=False)[1].release()


def release_group_programs() -> None:
    """Release every kept program whose value-and-grad runs collectives
    over a process group. The programs go before the groups do
    (parallel/distributed.destroy_group): a captured collective must never
    run on, or outlive, a destroyed communicator."""
    for key in [k for k, prog in _PROGRAMS.items()
                if prog.p.group is not None]:
        _PROGRAMS.pop(key).release()


def program_stats() -> dict:
    """The programs the cache holds and their bytes (pools and static
    buffers)."""
    return dict(programs=len(_PROGRAMS),
                bytes=sum(prog.bytes for prog in _PROGRAMS.values()),
                pool_bytes=sum(prog.pool_bytes for prog in _PROGRAMS.values()))


def _evict() -> None:
    """The least recently used programs go while the cache holds more than
    MAX_PROGRAM_BYTES; the newest stays. The cache is per process: the
    ranks of a model group make the same calls, so they keep and evict
    the same programs."""
    while (len(_PROGRAMS) > 1
           and program_stats()['bytes'] > MAX_PROGRAM_BYTES):
        _PROGRAMS.popitem(last=False)[1].release()


def _run_graphed(p: _Problem, u0):
    """The loop of `_run_eager` as replays of captured CUDA graphs, on the
    program's side stream: the same kernels on the same inputs, so the same
    bits and iterations; each replay counts the launches of its graph's
    kernel nodes (utils/replay_counts.py). With p.program, the solve's
    program is kept (above): a call that finds it replays its init and step
    graphs and captures nothing. A closure (p.program None) gets a program
    for this call only, whose graph and pool go when it returns. The result
    is a copy, made on the caller's stream."""
    dev = u0.device
    main = torch.cuda.current_stream(dev)
    key = None if p.program is None else _program_key(p, u0)
    prog = _PROGRAMS.get(key) if key is not None else None
    if prog is None:
        prog = _Program(p, u0, main, keep=key is not None)
        if key is not None:
            _PROGRAMS[key] = prog
            _evict()
    else:
        _PROGRAMS.move_to_end(key)
        prog.run(p, u0, main)
    main.wait_stream(prog.side)
    out = _clone(prog.state)
    if key is None:
        prog.release()
    return out


def _can_graph(device) -> bool:
    """Whether a solve on `device` may run its loop as captured graphs."""
    return device.type == 'cuda'


class Objective(NamedTuple):
    """A per-lane objective (B, H, da) -> (B,) given by what it is built
    from, so that a solve can keep its captured program: build(*inputs)
    returns the objective. `key` holds every Python value that the built
    code reads (hashable; the solver adds the inputs' shapes, strides,
    dtypes and devices); `inputs` the tensors it reads (entries may be
    None). A kept program copies each call's inputs into its own buffers
    and replays code built once on those buffers, so `build` must read its
    inputs only inside the objective it returns: a tensor derived from them
    outside it would be stale on the next call. Called on u, an Objective
    builds on its own inputs and evaluates."""
    key: Hashable
    inputs: tuple
    build: Callable[..., Callable[[torch.Tensor], torch.Tensor]]

    def __call__(self, u):
        return self.build(*self.inputs)(u)


class ValueAndGrad(NamedTuple):
    """An external value-and-grad u (B, H, da) -> (f (B,), g (B, H, da))
    given by what it is built from, as an `Objective` is, so that a solve
    can keep its captured program: build(*inputs) returns the oracle;
    `key` and `inputs` follow Objective's rule (build reads its inputs
    only inside the oracle it returns). `group` is the process group whose
    collectives the oracle runs, or None: it names the program
    (`_group_key`), decides whether the solve is captured
    (CAPTURED_BACKENDS) and binds the program's life to the group
    (`release_group_programs`). Called on u, it builds on its own inputs
    and evaluates."""
    key: Hashable
    inputs: tuple
    build: Callable[..., Callable]
    group: Optional[object] = None

    def __call__(self, u):
        return self.build(*self.inputs)(u)


def solve_trajectory_batched(objective_b, u_init: torch.Tensor, lb, ub,
                             config: SolverConfig = SolverConfig(),
                             val_and_grad: Optional[Callable] = None,
                             _graph: bool = True) -> SolveResult:
    """One lockstep solve of B lanes by config.method: L-BFGS, or projected
    Adam (each lane its own moments, step count and stop, then the polish
    on every lane; converged is None, as JAX's Adam gives none).
    objective_b: (B, H, da) -> (B,) independent per-lane objectives,
    differentiable by autograd: an `Objective` (its program is kept and
    reused across calls), or any callable. lb/ub broadcast against u_init.

    val_and_grad, if given, replaces autograd of objective_b (which may then
    be None): an external (f, g) oracle taking u (B, H, da) and returning
    f (B,) and g (B, H, da); L-BFGS only (Adam raises ValueError, as does
    an unknown method). A `ValueAndGrad` (the model-sharded value-and-grad
    of parallel/model_sharded.py, with its collectives inside) has its
    program kept as an Objective's is; a bare callable runs eagerly.

    On CUDA the solve runs as a kept program of captured CUDA graphs whose
    loop runs on the device (`_run_graphed`, `loop_form()`), unless the
    caller passes _graph=False (internal: `solve_trajectory`'s loop for an
    objective not held to capture), config.max_iters is 0 (no loop: the
    first value-and-grad only), val_and_grad is a bare callable, or it is a
    ValueAndGrad whose group's collectives cannot be captured. That last is
    a rule fixed in advance (`_collectives_captured`): a group of a backend
    in CAPTURED_BACKENDS for the device (NCCL on CUDA) is captured, its
    collectives inside the step graph; any other (gloo, whose all_reduce
    of a CUDA tensor goes through the host) runs eagerly; the CPU runs
    eagerly in any case. The objective must then read nothing on the host:
    the full-covariance rollout's PSD clip runs the sync-free eigensolver
    (ops/kernels/eigh_small.py) for that. Elsewhere, and on the CPU, the
    loop runs eagerly (`_run_eager`). A capture that fails raises; it never
    turns into the eager loop."""
    method = config.method
    if method not in _METHODS:
        raise ValueError(f'unknown method {method!r}')
    if method != 'lbfgs' and val_and_grad is not None:
        raise ValueError(f'an external val_and_grad runs under L-BFGS only, '
                         f'not method={method!r}')
    dt = u_init.dtype
    dev = u_init.device
    b = u_init.shape[0]
    shape = u_init.shape
    n = u_init[0].numel()
    lb_t, ub_t = (torch.as_tensor(v, dtype=dt, device=dev) for v in (lb, ub))
    lb_f = lb_t.broadcast_to(shape).reshape(b, n)
    ub_f = ub_t.broadcast_to(shape).reshape(b, n)

    def vg_of(obj):
        def vg(u):
            return _value_and_grad(obj, u, shape)
        return vg

    def vg_flat(oracle):
        def vg(u):
            f, g = oracle(u.reshape(shape))
            return f.detach(), g.detach().reshape(b, n)
        return vg

    program, group, kept = None, None, None
    if isinstance(val_and_grad, ValueAndGrad):
        kept, wrap, group = val_and_grad, vg_flat, val_and_grad.group
    elif val_and_grad is None and isinstance(objective_b, Objective):
        kept, wrap = objective_b, vg_of
    if kept is not None:
        def build(*inputs):
            return wrap(kept.build(*inputs))
        program = ((kept.key, tuple(shape), tuple(lb_t.shape),
                    tuple(ub_t.shape)), kept.inputs, build)
        vg = build(*kept.inputs)
    elif val_and_grad is not None:
        vg = vg_flat(val_and_grad)
    else:
        vg = vg_of(objective_b)

    p = _Problem(val_and_grad=vg, lb=lb_f, ub=ub_f,
                 zero=torch.zeros((), dtype=dt, device=dev), config=config,
                 program=program, method=method, group=group)
    graphed = (_graph and (val_and_grad is None or program is not None)
               and _can_graph(dev) and config.max_iters > 0
               and _collectives_captured(group, dev))
    s = (_run_graphed if graphed else _run_eager)(p, u_init.reshape(b, n))
    pg_norm = _pg_res(p, s.u, s.g)
    if method == 'adam':
        return SolveResult(u=s.u.reshape(shape), cost=s.f, iters=s.iters_b,
                           pg_norm=pg_norm)
    if config.noise_rel > 0.0:
        # Best-seen iterate; pg_norm belongs to the last iterate.
        return SolveResult(u=s.u_best.reshape(shape), cost=s.f_best,
                           iters=s.iters_b, pg_norm=pg_norm,
                           converged=s.done)
    return SolveResult(u=s.u.reshape(shape), cost=s.f, iters=s.iters_b,
                       pg_norm=pg_norm, converged=s.done)


def solve_trajectory(objective: Callable[[torch.Tensor], torch.Tensor],
                     u_init: torch.Tensor, lb, ub,
                     config: SolverConfig = SolverConfig()) -> SolveResult:
    """Minimize objective(u) (u (H, da) -> scalar, differentiable by
    autograd) over the box [lb, ub] (broadcast against u):
    `solve_trajectory_batched` at B = 1, its loop run eagerly (the closure
    may read the host)."""
    return first_lane(solve_trajectory_batched(
        lambda u_b: objective(u_b[0])[None], u_init[None], lb, ub, config,
        _graph=False))
