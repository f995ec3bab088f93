"""GPState: the padded, multi-output exact GP (port of gpmpc_tpu/gp/state.py).

The training set is a fixed-capacity padded buffer with a mask; one state
covers all E outputs that share inputs. Cached per fit:

  kinv   regularized Ky^{-1}              (E, cap, cap)
  beta   Ky^{-1} y on the valid rows      (E, cap)
  logdet log det Ky on the valid block    (E,)

The factorization runs in f64 on the state's device and is cast back to the
storage dtype: at the headline conditioning (cond(Ky) ~ 2e4) an f32 Cholesky
leaves ~1e-3 relative error in beta and kinv, a systematic model error the
H-step rollout amplifies. The default backend is the adaptive-jitter
Cholesky of the JAX package: no jitter first, then 10 eps * mean(diag Ky),
growing tenfold, nine attempts in all; the jitter is chosen without a
gradient and the Cholesky at that jitter carries it, so hyperparameter
training (gp/train.py) differentiates through the fit. Where the attempts
run out, the last jitter stands and the factor is NaN, as in the JAX
package. The search reads nothing on the host on the card: it is JAX's
`lax.while_loop`, a kept loop graph (ops/kernels/loop_cond.DeviceLoop) over
every output's (and lane's) matrix at once (`find_jitter`); on the CPU the
same loop reads all(done) on the host. GPConfig(solve_backend='eigh') takes
the spectrum-clipped eigendecomposition instead (torch.linalg.eigh waits on
the host).

A state may be stacked over B lanes (parallel.batch.stack_gps: a leading
(B,) axis on every tensor), JAX's vmap of one GP: the fit and `append` take
it, each lane with its own rows, count and fit.

`append` writes new rows on the device with a masked write (rows past the
capacity are dropped) and refits; `grow` repads to a larger capacity;
`set_hyperparams` sets hyperparameters in natural space and refits.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.gp.kernels import se_gram_batched
from gpmpc_tpu_torch.ops.kernels import loop_cond
from gpmpc_tpu_torch.utils import replay_counts
from gpmpc_tpu_torch.utils.linalg import chol_logdet, masked_psd_add


@dataclass(frozen=True)
class GPConfig:
    """Static configuration."""
    capacity: int = 256
    x_dim: int = 1
    out_dim: int = 1
    jitter: float = 0.0
    # All output GPs share one lengthscale vector; auto-detected by make_gp.
    # Enables the shared-exp-chain variance kernel; never changes results.
    tied_lambdas: bool = False
    # Nominal mean model f_nom: (n, x_dim) -> (n, out_dim) torch tensors.
    # When set, the GP fits the residual y - f_nom(x), and dynamics.rollout
    # adds f_nom back (first-order moment propagation).
    nominal_fn: Optional[Callable] = None
    # Factorization backend: 'chol' (adaptive-jitter Cholesky) or 'eigh'
    # (eigendecomposition with the spectrum clipped at N eps w_max).
    solve_backend: str = 'chol'


@dataclass(frozen=True)
class GPState:
    config: GPConfig
    x: torch.Tensor            # (cap, x_dim) padded training inputs
    y: torch.Tensor            # (E, cap) padded targets, one row per output
    mask: torch.Tensor         # (cap,) bool validity
    count: torch.Tensor        # () int32 number of valid rows
    log_lambdas: torch.Tensor  # (E, x_dim)
    log_sigma_f: torch.Tensor  # (E,)
    log_sigma_n: torch.Tensor  # (E,)
    kinv: torch.Tensor         # (E, cap, cap)
    beta: torch.Tensor         # (E, cap)
    logdet: torch.Tensor       # (E,)
    jitter_used: torch.Tensor  # (E,)

    @property
    def capacity(self) -> int:
        return self.config.capacity

    @property
    def lambdas(self) -> torch.Tensor:
        return torch.exp(self.log_lambdas)

    @property
    def sigma_f(self) -> torch.Tensor:
        return torch.exp(self.log_sigma_f)

    @property
    def sigma_n(self) -> torch.Tensor:
        return torch.exp(self.log_sigma_n)


def residuals(state: GPState) -> torch.Tensor:
    """(E, cap) masked targets minus the nominal mean (zero where padded);
    (B, E, cap) for a state stacked over lanes."""
    y = state.y
    nom = state.config.nominal_fn
    if nom is not None:
        y = y - (torch.func.vmap(lambda x: nom(x).T)(state.x)
                 if state.x.ndim == 3 else nom(state.x).T)
    return y * state.mask[..., None, :].to(y.dtype)


_ESCALATIONS = 8           # jitter escalations after the base attempt
# A fit of at most this many matrices (one GP's outputs) factorizes and
# solves them one call a matrix: cuSOLVER's potrf and potrs at batch 1, as
# fast as the batched calls at a few matrices and the bits the fit has
# always had on the card; more (a GP stacked over lanes) go in one batched
# call each (at 512 matrices of N = 512 on an H100: the Cholesky ~7 ms
# against ~116 ms a matrix at a time, the inverse by two batched triangular
# solves ~17 ms against ~208 ms; benchmarks/fit_calls.py, PERF.md).
_EACH_MAX = 8


def _each(a) -> bool:
    return a.shape[:-2].numel() <= _EACH_MAX


def _cholesky_ex(a):
    """(L, info) of every matrix of a (..., N, N), reading nothing on the
    host (`_EACH_MAX` says how the calls are made)."""
    if not _each(a):
        return torch.linalg.cholesky_ex(a)
    parts = [torch.linalg.cholesky_ex(m) for m in a.reshape(-1, *a.shape[-2:])]
    return (torch.stack([l for l, _ in parts]).reshape(a.shape),
            torch.stack([i for _, i in parts]).reshape(a.shape[:-2]))


def _chol_solve(chol, b):
    """A x = b from A's lower factor, chol (..., N, N), b (..., N, M):
    torch.cholesky_solve a matrix at a time, or two batched triangular
    solves (cuBLAS; the batched cholesky_solve takes MAGMA on the card)."""
    if _each(chol):
        return torch.stack([torch.cholesky_solve(y, c) for c, y in zip(
            chol.reshape(-1, *chol.shape[-2:]),
            b.reshape(-1, *b.shape[-2:]))]).reshape(b.shape)
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def _shifted(ky, j, dmask):
    """ky + j diag(dmask) for each matrix: ky (..., N, N); j (...,);
    dmask (..., N), the valid rows as ky's dtype."""
    return ky + torch.diag_embed(j[..., None] * dmask)


def _factorizes(ky, j, dmask):
    """Whether each matrix factorizes at its jitter (cholesky_ex's info, read
    on the device)."""
    return _cholesky_ex(_shifted(ky, j, dmask))[1] == 0


def _escalate(ky, dmask, eps0, j, done):
    """One escalation: j <- eps0 where j = 0, else 10 j, on the matrices not
    done (the others keep theirs, as JAX's vmapped while_loop keeps them
    with a select); returns (j, done) after the new attempt."""
    j = torch.where(done, j, torch.where(j == 0.0, eps0, j * 10.0))
    return j, _factorizes(ky, j, dmask)


class _JitterSearch:
    """The jitter escalation of one shape of fit on the card: static
    buffers (the matrices, their diagonal masks, eps0, j, done, t) and the
    loop graph (ops/kernels/loop_cond.DeviceLoop) whose WHILE node runs
    `_escalate` while t < 8 and a matrix has not factorized. `prepare`
    writes a fit's inputs and makes the base attempt; `launch` runs the
    loop; j is then the jitters. The first launch runs escalation 1 eagerly
    (the warm-up a capture needs) and captures the step. Its passes are
    summed on the device and counted by `settle` (utils/replay_counts.watch),
    as a solve program's are."""

    def __init__(self, ky, dev):
        lead = ky.shape[:-2]
        self.side = torch.cuda.Stream(device=dev)
        self.side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(self.side):
            self.ky = torch.empty_like(ky)
            self.dmask = ky.new_empty(ky.shape[:-1])
            self.eps0 = ky.new_empty(lead)
            self.j = ky.new_empty(lead)
            self.done = torch.empty(lead, dtype=torch.bool, device=dev)
            self.t = torch.zeros((), dtype=torch.long, device=dev)
            self.passes = torch.zeros((), dtype=torch.long, device=dev)
        self.loop, self.launched, self.dev = None, 0, dev
        replay_counts.watch(self)

    def prepare(self, ky, dmask, eps0, base: float) -> None:
        """The fit's matrices, masks and eps0 into the buffers, j = base,
        t = 0 and the base attempt, on the caller's stream (capturable)."""
        self.ky.copy_(ky)
        self.dmask.copy_(dmask)
        self.eps0.copy_(eps0)
        self.j.fill_(base)
        self.t.zero_()
        self.done.copy_(_factorizes(self.ky, self.j, self.dmask))

    def _step(self) -> None:
        j, done = _escalate(self.ky, self.dmask, self.eps0, self.j, self.done)
        self.j.copy_(j)
        self.done.copy_(done)
        self.t.add_(1)

    def launch(self) -> None:
        """The loop on the caller's stream (the first call builds it)."""
        main = torch.cuda.current_stream(self.dev)
        self.side.wait_stream(main)
        with torch.cuda.device(self.dev), torch.cuda.stream(self.side):
            if self.loop is None:
                self._step()
                self.loop = loop_cond.DeviceLoop(
                    self._step, self.t, self.done.view(-1), _ESCALATIONS,
                    torch.cuda.graph_pool_handle())
            self.passes.sub_(self.t)
            self.loop.launch()
            self.passes.add_(self.t)
            self.launched += 1
        main.wait_stream(self.side)

    def settle(self) -> None:
        """Count the condition kernel's launches since the last settle (one a
        loop launch, one a pass). Waits for the search's stream."""
        if not self.launched:
            return
        with torch.cuda.stream(self.side):
            n = int(self.passes)
            self.passes.zero_()
        launched, self.launched = self.launched, 0
        loop_cond.add_launches(launched + n)

    def release(self) -> None:
        self.side.synchronize()
        self.settle()
        if self.loop is not None:
            self.loop.reset()
            self.loop = None


# The kept searches by (shape, dtype, device): the port's counterpart of the
# compiled while_loop of each fit shape.
_SEARCHES: dict = {}
# Where set (sim/simulator.py's step capture), the searches' launches go to
# this callable instead of running: it ends the graph being captured, keeps
# the search's launch as a step of its own, and starts the next graph.
_LAUNCH_HOOK: Optional[Callable] = None


def clear_searches() -> None:
    """Drop every kept jitter search (its buffers and loop graph)."""
    while _SEARCHES:
        _SEARCHES.popitem()[1].release()


def search_stats() -> dict:
    """The kept jitter searches and their static buffers' bytes."""
    return dict(searches=len(_SEARCHES), bytes=sum(
        t.numel() * t.element_size() for s in _SEARCHES.values()
        for t in (s.ky, s.dmask, s.eps0, s.j, s.done)))


def _device_loop(dev) -> bool:
    """Whether a search on `dev` runs as the device loop: the solver's
    choice of loop (mpc/solver.py `_loop_of`: CUDA, a driver that runs
    conditional nodes, outside `_host_read_loop()`)."""
    from gpmpc_tpu_torch.mpc import solver
    return solver._loop_of(dev) == 'while'


def find_jitter(ky, dmask, eps0, base: float):
    """The jitter of each matrix ky (..., N, N), JAX's `_find_jitter`: base,
    then escalations to eps0 and tenfold, at most 8, until
    cholesky_ex(ky + j diag(dmask)) factorizes; a matrix that never does
    keeps the last j (its factor is then NaN, as JAX's). ky carries no
    gradient. On the card a kept `_JitterSearch` (no host read); elsewhere
    the host-read loop (all(done) read once an escalation, counted in
    utils/replay_counts.HOST_READS)."""
    if ky.device.type == 'cuda' and _device_loop(ky.device):
        key = (tuple(ky.shape), ky.dtype, ky.device)
        search = _SEARCHES.get(key)
        if search is None:
            search = _SEARCHES[key] = _JitterSearch(ky, ky.device)
        search.prepare(ky, dmask, eps0, base)
        (_LAUNCH_HOOK or _JitterSearch.launch)(search)
        return search.j.clone()
    j = torch.full_like(eps0, base)
    done = _factorizes(ky, j, dmask)
    for _ in range(_ESCALATIONS):
        replay_counts.host_read()
        if bool(done.all()):
            break
        j, done = _escalate(ky, dmask, eps0, j, done)
    return j


def _solve_chol(ky, m, resid, base_jitter, need_kinv):
    """(kinv or None, beta, logdet, jitter) of every output's matrix by the
    escalating-jitter Cholesky, JAX's `_solve_chol`: ky (..., E, N, N),
    m (..., N) the mask as ky's dtype, resid (..., E, N). The search runs on
    the detached matrices (`find_jitter`); the factor at the jitter found
    carries ky's gradient, and is NaN where the escalation ran out."""
    dmask = m[..., None, :].expand(resid.shape)
    n_valid = torch.clamp(torch.sum(m, dim=-1), min=1.0)[..., None]
    mean_diag = torch.sum(torch.diagonal(ky, dim1=-2, dim2=-1).detach()
                          * dmask, dim=-1) / n_valid
    eps0 = 10.0 * torch.finfo(ky.dtype).eps * mean_diag
    j = find_jitter(ky.detach(), dmask, eps0, float(base_jitter))
    chol, info = _cholesky_ex(_shifted(ky, j, dmask))
    chol = torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float('nan')))
    eye = torch.eye(ky.shape[-1], dtype=ky.dtype, device=ky.device)
    kinv = _chol_solve(chol, eye.expand_as(chol)) if need_kinv else None
    beta = _chol_solve(chol, resid[..., None])[..., 0]
    return kinv, beta, chol_logdet(chol), j


def _solve_eigh(ky, m, resid, base_jitter, need_kinv):
    """(kinv or None, beta, logdet, clip floor) of every output's matrix
    from the eigendecomposition with the spectrum clipped at max(jitter,
    N eps w_max): the exact posterior in well-conditioned directions; the
    padded block's unit eigenvalues add 0 to logdet. Shapes as
    `_solve_chol`. torch.linalg.eigh waits on the host (PERF.md)."""
    w, v = torch.linalg.eigh(ky)
    floor = torch.clamp(ky.shape[-1] * torch.finfo(ky.dtype).eps * w[..., -1],
                        min=float(base_jitter))
    w_clip = torch.clamp(w, min=floor[..., None])
    w_inv = 1.0 / w_clip
    kinv = (v * w_inv[..., None, :]) @ v.mT if need_kinv else None
    beta = (v @ (w_inv * (v.mT @ resid[..., None])[..., 0])[..., None])[..., 0]
    return kinv, beta, torch.sum(torch.log(w_clip), dim=-1), floor


def _ky(x, mask, log_lambdas, log_sigma_f, log_sigma_n):
    """The masked Ky (E, N, N) of one GP's data and hyperparameters."""
    kf = se_gram_batched(x, x, log_lambdas, log_sigma_f)
    return masked_psd_add(kf, mask, torch.exp(2.0 * log_sigma_n))


def fit_f64(state: GPState, need_kinv: bool = True):
    """(kinv (E, cap, cap) or None, beta (E, cap), logdet (E,), jitter (E,))
    of the masked Ky under the state's data and hyperparameters, all in f64,
    differentiable w.r.t. the log hyperparameters (the jitter is not). A
    state stacked over lanes (x of rank 3, `parallel.batch.stack_gps`) gives
    every output a leading (B,) axis, all lanes' matrices in one search."""
    cfg = state.config
    if cfg.solve_backend not in ('chol', 'eigh'):
        raise ValueError(f'unknown solve_backend {cfg.solve_backend!r}')
    f64 = torch.float64
    hp = (state.log_lambdas.to(f64), state.log_sigma_f.to(f64),
          state.log_sigma_n.to(f64))
    x = state.x.to(f64)
    ky = (torch.func.vmap(_ky)(x, state.mask, *hp) if x.ndim == 3
          else _ky(x, state.mask, *hp))
    resid = residuals(state).to(f64)
    m = state.mask.to(f64)
    solver = _solve_chol if cfg.solve_backend == 'chol' else _solve_eigh
    return solver(ky, m, resid, cfg.jitter, need_kinv)


def _factorize(state: GPState) -> GPState:
    """Rebuild kinv / beta / logdet under the current data and hyperparameters
    (masked Ky with a unit padded diagonal), in f64, cast to the storage
    dtype."""
    dt = state.x.dtype
    kinv, beta, logdet, jit = fit_f64(state)
    return replace(state, kinv=kinv.to(dt), beta=beta.to(dt),
                   logdet=logdet.to(dt), jitter_used=jit.to(dt))


fit = _factorize


def _rows_tied(v) -> bool:
    """True iff the lengthscale spec `v` has equal per-output rows
    (None, scalar and 1-D specs broadcast to every output, so they tie)."""
    if v is None:
        return True
    arr = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    if arr.ndim <= 1:
        return True
    return bool(np.all(arr == arr[0]))


def make_gp(config: GPConfig, x=None, y=None, log_lambdas=None,
            log_sigma_f=None, log_sigma_n=None, dtype=torch.float32,
            device=None) -> GPState:
    """Create a fitted GPState, optionally pre-loaded with training data.

    x: (n, x_dim); y: (n, out_dim), array-likes loaded into the padded
    buffers. Hyperparameters default to log(1) = 0. `device` defaults to CUDA.
    """
    dev = resolve_device(device)
    cap, d, e = config.capacity, config.x_dim, config.out_dim
    xb = torch.zeros((cap, d), dtype=dtype, device=dev)
    yb = torch.zeros((e, cap), dtype=dtype, device=dev)
    mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
    n = 0
    if x is not None:
        xt = torch.tensor(np.asarray(x), dtype=dtype, device=dev).reshape(-1, d)
        yt = torch.tensor(np.asarray(y), dtype=dtype, device=dev).reshape(-1, e)
        n = xt.shape[0]
        if n > cap:
            raise ValueError(f'{n} training points exceed capacity {cap}')
        xb[:n] = xt
        yb[:, :n] = yt.T
        mask[:n] = True

    def _hp(v, shape):
        if v is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.tensor(np.asarray(v), dtype=dtype,
                            device=dev).broadcast_to(shape).clone()

    state = GPState(
        config=replace(config, tied_lambdas=_rows_tied(log_lambdas)),
        x=xb, y=yb, mask=mask,
        count=torch.tensor(n, dtype=torch.int32, device=dev),
        log_lambdas=_hp(log_lambdas, (e, d)),
        log_sigma_f=_hp(log_sigma_f, (e,)),
        log_sigma_n=_hp(log_sigma_n, (e,)),
        kinv=torch.zeros((e, cap, cap), dtype=dtype, device=dev),
        beta=torch.zeros((e, cap), dtype=dtype, device=dev),
        logdet=torch.zeros((e,), dtype=dtype, device=dev),
        jitter_used=torch.zeros((e,), dtype=dtype, device=dev))
    return _factorize(state)


def append(state: GPState, x_new, y_new) -> GPState:
    """Append observations on the state's device and refit.

    x_new: (x_dim,) or (n, x_dim); y_new: (out_dim,) or (n, out_dim), tensors
    or array-likes; for a state stacked over B lanes, (B, x_dim) or
    (B, n, x_dim) and (B, out_dim) or (B, n, out_dim), each lane's rows
    written at its own count. Rows that do not fit in the capacity are
    dropped (`grow` repads): they are written to a spare row that is cut
    off, so the count never leaves the device before the fit."""
    cfg = state.config
    dev = state.x.device
    lanes = state.x.shape[:-2]                   # () or (B,)
    x_new = torch.as_tensor(x_new, dtype=state.x.dtype,
                            device=dev).reshape(*lanes, -1, cfg.x_dim)
    y_new = torch.as_tensor(y_new, dtype=state.y.dtype,
                            device=dev).reshape(*lanes, -1, cfg.out_dim)
    n, cap = x_new.shape[-2], cfg.capacity
    idx = state.count.long()[..., None] + torch.arange(n, device=dev)
    slot = torch.where(idx < cap, idx, torch.full_like(idx, cap))
    x = torch.cat([state.x, state.x.new_zeros((*lanes, 1, cfg.x_dim))], -2)
    y = torch.cat([state.y, state.y.new_zeros((*lanes, cfg.out_dim, 1))], -1)
    mask = torch.cat([state.mask, state.mask.new_zeros((*lanes, 1))], -1)
    at = (slot,) if not lanes else (
        torch.arange(lanes[0], device=dev)[:, None], slot)
    x[at] = x_new
    y.transpose(-1, -2)[at] = y_new
    mask[at] = mask.new_ones(())
    count = torch.clamp(state.count + n, max=cap).to(torch.int32)
    return _factorize(replace(state, x=x[..., :cap, :], y=y[..., :cap],
                              mask=mask[..., :cap], count=count))


# Alias for loop bodies where `append` names a local.
gp_append = append


def grow(state: GPState, new_capacity: int) -> GPState:
    """Repad to a larger capacity and refit."""
    if new_capacity < state.config.capacity:
        raise ValueError('new capacity must be >= current capacity')
    pad = new_capacity - state.config.capacity
    e = state.config.out_dim
    return _factorize(replace(
        state, config=replace(state.config, capacity=new_capacity),
        x=torch.nn.functional.pad(state.x, (0, 0, 0, pad)),
        y=torch.nn.functional.pad(state.y, (0, pad)),
        mask=torch.nn.functional.pad(state.mask, (0, pad)),
        kinv=state.kinv.new_zeros((e, new_capacity, new_capacity)),
        beta=state.beta.new_zeros((e, new_capacity))))


def set_hyperparams(state: GPState, lambdas=None, sigma_f=None, sigma_n=None,
                    refit: bool = True) -> GPState:
    """Set hyperparameters in natural (not log) space, broadcast to every
    output; lengthscales re-detect `tied_lambdas`. Refits unless
    refit=False."""
    e, d = state.log_lambdas.shape
    dt, dev = state.log_lambdas.dtype, state.x.device

    def log_of(v, shape):
        v = (v.to(dt) if isinstance(v, torch.Tensor)
             else torch.tensor(np.asarray(v), dtype=dt))
        return torch.log(v.to(dev)).broadcast_to(shape).clone()

    if lambdas is not None:
        state = replace(state, log_lambdas=log_of(lambdas, (e, d)),
                        config=replace(state.config,
                                       tied_lambdas=_rows_tied(lambdas)))
    if sigma_f is not None:
        state = replace(state, log_sigma_f=log_of(sigma_f, (e,)))
    if sigma_n is not None:
        state = replace(state, log_sigma_n=log_of(sigma_n, (e,)))
    return _factorize(state) if refit else state
