"""Box-constrained trajectory solvers (port of gpmpc_tpu/mpc/solver.py).

`solve_trajectory_batched`: lockstep projected L-BFGS over B independent
solves. Every lane has its own acceptance, step size, history and
convergence; lanes that are done freeze while the loop runs on until all are
done or the iteration cap. One iteration is `_lbfgs_step`, a function of the
carry `LbfgsState`. JAX's `lax.while_loop` compiles the loop into one
program on the device; here the loop stays on the host and reads `all(done)`
once an iteration, so the iteration count is the JAX one. What runs each
iteration depends on where it runs. On CUDA, with the objective's own
autograd (the diagonal `solve_batch`, the multistart recipes,
`solve_batch_staged` and the controller's batched route), iteration 1 runs
eagerly and every later one is a replay of one CUDA graph captured from
`_lbfgs_step`, one host launch an iteration (`_run_graphed`). On the CPU,
with an external value-and-grad, and where the caller says `_graph=False`
(full covariance, `solve_trajectory`), each iteration runs its torch ops
from Python (`_run_eager`). Both run the same kernels on the same inputs.

`solve_trajectory`: one solve of objective(u) -> scalar, by projected L-BFGS
(method='lbfgs', the batched solver at B = 1: JAX's single-scenario L-BFGS
is the same recurrence lane for lane) or by projected Adam with a fixed step
and an optional polish of normalized-gradient steps (method='adam').
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

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
    # step decaying by 2^(-1/4) each (solve_trajectory with Adam).
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
    """Lane 0 of a batched result, shaped as a single solve's."""
    return SolveResult(*(t[0] for t in res))


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


def _go_on(s: LbfgsState, t: int, max_iters: int) -> bool:
    """The loop's condition, JAX's while_loop cond: below the cap and a lane
    not done (one read on the host an iteration)."""
    return t < max_iters and not bool(s.done.all())


def _run_eager(p: _Problem, s: LbfgsState) -> LbfgsState:
    t = 0
    while _go_on(s, t, p.config.max_iters):
        s = _lbfgs_step(p, s)
        t += 1
    return s


def _step_in_place(p: _Problem, s: LbfgsState) -> None:
    """One `_lbfgs_step` written back into s's own tensors (`copy_`), which
    must not alias one another: the code a capture records."""
    out = _lbfgs_step(p, s)
    for dst, src in zip(s, out):
        if src is not dst:
            dst.copy_(src)


def _capture_step(p: _Problem, s: LbfgsState):
    """A CUDA graph of `_step_in_place` on the static buffers s, on the
    current stream (a side stream that has run the step eagerly: its lazy
    initialisation is done). Capture records and runs nothing. Returns the
    instantiated graph and its counts (utils/replay_counts.Replays: the
    kernel launches of a replay read from the graph's nodes). A step that
    waits on the host raises here."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = replay_counts.snapshot()
    graph.capture_begin()
    try:
        _step_in_place(p, s)
    except BaseException:
        # The capture is broken already: end it, and raise the cause.
        with contextlib.suppress(RuntimeError):
            graph.capture_end()
        raise
    graph.capture_end()
    counts = replay_counts.Replays(
        before, replay_counts.snapshot(),
        replay_counts.graph_kernel_names(graph.raw_cuda_graph()))
    graph.instantiate()
    return graph, counts


def _run_graphed(p: _Problem, s: LbfgsState) -> LbfgsState:
    """The loop of `_run_eager`, its iterations after the first replays of
    one captured graph of `_lbfgs_step`, run on a side stream: iteration 1
    eagerly (the warm-up capture needs), then one capture into static
    buffers, then one replay and one read of done an iteration. Same
    kernels on the same inputs, so the same bits and iterations; each
    replay counts the launches of the graph's kernel nodes
    (utils/replay_counts.py). The graph and its memory pool go when the
    call returns."""
    max_iters = p.config.max_iters
    dev = s.u.device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(main)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        t = 0
        if _go_on(s, t, max_iters):
            s = _lbfgs_step(p, s)
            t += 1
        if _go_on(s, t, max_iters):
            # Distinct buffers: a field may alias another (f_best is f until
            # the noise mode moves it).
            s = LbfgsState(*(x.clone() for x in s))
            graph, counts = _capture_step(p, s)
            try:
                while _go_on(s, t, max_iters):
                    graph.replay()
                    counts.replayed()
                    t += 1
            finally:
                graph.reset()
    main.wait_stream(side)
    return s


def solve_trajectory_batched(objective_b: Optional[Callable[[torch.Tensor],
                                                             torch.Tensor]],
                             u_init: torch.Tensor, lb, ub,
                             config: SolverConfig = SolverConfig(),
                             val_and_grad: Optional[Callable] = None,
                             _graph: bool = True) -> SolveResult:
    """objective_b: (B, H, da) -> (B,) independent per-lane objectives,
    differentiable by autograd. lb/ub broadcast against u_init.

    val_and_grad, if given, replaces autograd of objective_b (which may then
    be None): an external (f, g) oracle taking u (B, H, da) and returning
    f (B,) and g (B, H, da), e.g. the collective program of
    parallel/model_sharded.py.

    On CUDA the iterations after the first run as replays of one captured
    CUDA graph (`_run_graphed`), unless val_and_grad is given (an external
    oracle, with collectives inside) or the caller passes _graph=False
    (internal: for an objective that waits on the host, such as
    full_cov=True's PSD clip). Elsewhere, and on the CPU, the loop runs
    eagerly. A capture that fails raises; it never turns into the eager
    loop."""
    dt = u_init.dtype
    dev = u_init.device
    b = u_init.shape[0]
    shape = u_init.shape
    n = u_init[0].numel()
    lb_f = torch.as_tensor(lb, dtype=dt, device=dev).broadcast_to(shape).reshape(b, n)
    ub_f = torch.as_tensor(ub, dtype=dt, device=dev).broadcast_to(shape).reshape(b, n)

    if val_and_grad is None:
        def vg(u):
            return _value_and_grad(objective_b, u, shape)
    else:
        def vg(u):
            f, g = val_and_grad(u.reshape(shape))
            return f.detach(), g.detach().reshape(b, n)

    p = _Problem(val_and_grad=vg, lb=lb_f, ub=ub_f,
                 zero=torch.zeros((), dtype=dt, device=dev), config=config)
    s = _lbfgs_init(p, u_init.reshape(b, n))
    graphed = _graph and val_and_grad is None and dev.type == 'cuda'
    s = (_run_graphed if graphed else _run_eager)(p, s)
    if config.noise_rel > 0.0:
        # Best-seen iterate; pg_norm belongs to the last iterate.
        return SolveResult(u=s.u_best.reshape(shape), cost=s.f_best,
                           iters=s.iters_b, pg_norm=_pg_res(p, s.u, s.g),
                           converged=s.done)
    return SolveResult(u=s.u.reshape(shape), cost=s.f, iters=s.iters_b,
                       pg_norm=_pg_res(p, s.u, s.g), converged=s.done)


def solve_trajectory(objective: Callable[[torch.Tensor], torch.Tensor],
                     u_init: torch.Tensor, lb, ub,
                     config: SolverConfig = SolverConfig()) -> SolveResult:
    """Minimize objective(u) (u (H, da) -> scalar, differentiable by
    autograd) over the box [lb, ub] (broadcast against u)."""
    if config.method == 'lbfgs':
        return _solve_lbfgs(objective, u_init, lb, ub, config)
    if config.method == 'adam':
        return _solve_adam(objective, u_init, lb, ub, config)
    raise ValueError(f'unknown method {config.method!r}')


def _solve_lbfgs(objective, u_init, lb, ub, config: SolverConfig) -> SolveResult:
    """The lockstep solver at B = 1: the single JAX solve's acceptance, step
    size, history, restarts, stop and result, lane for lane. Its loop runs
    eagerly: the single-scenario objective may wait on the host (its full
    covariance does)."""
    return first_lane(solve_trajectory_batched(
        lambda u_b: objective(u_b[0])[None], u_init[None], lb, ub, config,
        _graph=False))


def _solve_adam(objective, u_init, lb, ub, config: SolverConfig) -> SolveResult:
    """Projected Adam, one gradient an iteration, stopped at the projected-
    gradient residual < tol or the cap; then `polish_iters` steps of
    lr 2^(-i/4) g / (max|g| + eps). Non-finite gradients count as 0 in the
    steps; the returned pg_norm reads the final gradient as it is (NaN where
    it is not finite), as JAX's does."""
    dt, dev = u_init.dtype, u_init.device
    lb = torch.as_tensor(lb, dtype=dt, device=dev).broadcast_to(u_init.shape)
    ub = torch.as_tensor(ub, dtype=dt, device=dev).broadcast_to(u_init.shape)
    lr = config.learning_rate

    def proj(u):
        return torch.minimum(torch.maximum(u, lb), ub)

    def grad(u, finite=True):
        u_var = u.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(objective(u_var), u_var)
        if not finite:
            return g
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    def pg_residual(u, g):
        return torch.amax(torch.abs(u - proj(u - g)))

    u = proj(u_init)
    g = grad(u)
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    t = 0
    done = False
    while t < config.max_iters and not done:
        m = config.b1 * m + (1.0 - config.b1) * g
        v = config.b2 * v + (1.0 - config.b2) * g * g
        t += 1
        mhat = m / (1.0 - config.b1 ** t)
        vhat = v / (1.0 - config.b2 ** t)
        u = proj(u - lr * mhat / (torch.sqrt(vhat) + config.eps))
        g = grad(u)
        done = bool(pg_residual(u, g) < config.tol)
    for i in range(config.polish_iters):
        gp = grad(u)
        step = lr * 0.5 ** (i / 4.0)
        u = proj(u - step * gp / (torch.amax(torch.abs(gp)) + config.eps))
    with torch.no_grad():
        cost = objective(u)
    return SolveResult(u=u, cost=cost,
                       iters=torch.tensor(t, dtype=torch.int32, device=dev),
                       pg_norm=pg_residual(u, grad(u, finite=False)))
