#!/usr/bin/env python3
"""Drive the gpmpc_tpu_torch port on one NVIDIA GPU and check it.

Run from the repository root: python3 chip_smoke.py [--out DIR]
(DIR, default chip_smoke_out/, receives the run summary and a profiler table)

Phases (each one fails the script with a non-zero exit; nothing is caught):
  1. device     CUDA present; the card's name and power limit.
  2. build      every CUDA source under gpmpc_tpu_torch/ops/kernels/csrc is
                compiled by nvcc into gpmpc_tpu_torch/_build/.
  3. kernels    K1 (tied) and K2 (untied) in f32 against their plain PyTorch
                versions in f64 on the card, at the headline shape and a
                ragged one, on the JAX kernel test's inputs: forward rtol
                5e-5 (atol 5e-5), backward rtol 2e-3 (atol 2e-4), that
                test's bars. On the headline GP's own x and b_lam, whose
                trace cancels, the kernels in f32 and in f64 against the
                plain f64 version: rtol 5e-5 (f32) or 1e-12 (f64) of |t| plus
                16 ulps of the terms' magnitude sum. Each kernel is timed
                with CUDA events beside its plain version and its bound.
  4. objective  the port's f64 objective on the card (the f64 kernel instance)
                at the reference controls and at 0 against the JAX package's
                values in gpmpc_tpu_torch/data/headline_ref.npz, rtol 1e-8.
  5. solve      the main path: solve_batch on the headline problem (B=256,
                H=20, f32, 40 iterations): finite costs, no lane worse than
                its start, and exactly H * (1 + iterations) K1 launches.
                Solves/s over fresh x0s, and the cost excess against the f64
                reference controls. Then the untied path (K2) on the same
                problem with per-output lengthscales, and a profiler pass.
  6. output     the card line, one `kernels` JSON line and the result line.

Times, rates and bounds printed here are measured in this run on this card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(ROOT, 'gpmpc_tpu_torch', 'data', 'headline_ref.npz')
SOURCE = 'gpmpc_tpu_torch/ops/kernels/csrc/variance_trace_tied.cu'
TPU_FILE = 'gpmpc_tpu/ops/pallas/variance_trace.py'

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32
# outside the tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FWD_TOL = dict(rtol=5e-5, atol=5e-5)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
OBJ_RTOL = 1e-8
ITERS = 40
UNTIED_ITERS = 10
# The headline inputs' range: (theta, omega, action) in [-pi, pi]^2 x [-5, 5].
DATA_SCALE = np.array([np.pi, np.pi, 5.0])


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assert_close(name, got, want, rtol, atol) -> float:
    """Max abs error; raises AssertionError past rtol/atol."""
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(got - want)))


def bound_ms(b, n_out, n_c, d, e, chains):
    """Least time for the rw function on this card: the larger of its f32
    operations over the f32 peak and its bytes (each input read once, each
    output written once) over the memory rate. Per (i, j) pair and exp chain:
    d multiply-adds and one scale for the exponent, one exp, and per output
    one blam multiply and (1 + d) multiply-adds."""
    w1 = d + 1
    e_per_chain = e // chains
    flops = b * n_out * n_c * chains * (2 * d + 2 + e_per_chain * (1 + 2 * w1))
    nbytes = 4 * (b * n_out * (d + 1) * chains + b * n_c * (d + w1) * chains
                  + e * n_c * n_out + b * e * n_out * w1)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def instr_bound_ms(b, n, d, e, props, clock_mhz):
    """Instruction-rate estimate from the card's own SM count and clock:
    d FMAs + 1 scale + ~8 for the accurate expf + E * (1 + (1+d)) per pair,
    at 128 f32 lanes per SM per cycle."""
    instr = b * n * n * (d + 1 + 8 + e * (1 + d + 1))
    return 1e3 * instr / (props.multi_processor_count * 128 * clock_mhz * 1e6)


def as64(v, dev):
    import torch
    return torch.tensor(v, dtype=torch.float64, device=dev)


def kernel_test_inputs(rng, b, n, d, e, tied, dev):
    """Inputs drawn as the JAX kernel test draws them (tests/test_batched.py,
    TestTiedStreamedKernel._problem): normal u and x, M2 = 0.1 m m^T + I, a
    random symmetric blam of scale 0.003, a normal cotangent; f64 on `dev`."""
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, d, d) if tied else (b, e, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n, d))
    br = rng.normal(size=(e, n, n)) * 0.003
    ct = rng.normal(size=(b, e))
    return tuple(as64(v, dev) for v in (u, m2, x, br + np.swapaxes(br, -1, -2),
                                        ct))


def headline_inputs(rng, b, cache, dev, tied):
    """The headline GP's own x (N, d) and b_lam (E, N, N) beside random u in
    the data's range and random SPD M2 (numpy seed); f64 on `dev`."""
    import torch
    d, e = cache.x.shape[1], cache.b_lam.shape[0]
    u = rng.uniform(-1.0, 1.0, (b, d)) * DATA_SCALE
    m = rng.normal(size=(b, d, d) if tied else (b, e, d, d))
    m2 = 0.5 * (m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d))
    return (as64(u, dev), as64(m2, dev), cache.x.to(dev, torch.float64),
            cache.b_lam.to(dev, torch.float64))


def trace_fns(tied):
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    if tied:
        return (vt.variance_trace_batched_tied,
                vt.variance_trace_batched_tied_reference)
    return vt.variance_trace_batched, vt.variance_trace_batched_reference


def check_trace(name, tied, u, m2, x, blam, ct):
    """The f32 wrapper (the kernel, on CUDA) against the plain version in f64:
    value and the analytic (du, dm2) against autograd of the plain version.
    Returns the max abs forward error."""
    import torch
    fn, ref = trace_fns(tied)

    def run(f, dtype):
        uu = u.to(dtype).requires_grad_()
        mm = m2.to(dtype).requires_grad_()
        out = f(uu, mm, x.to(dtype), blam.to(dtype))
        return (out, *torch.autograd.grad(torch.sum(out * ct.to(dtype)),
                                          (uu, mm)))

    k_out, k_du, k_dm2 = run(fn, torch.float32)
    r_out, r_du, r_dm2 = run(ref, torch.float64)
    err = assert_close(f'{name} forward', k_out, r_out, **FWD_TOL)
    assert_close(f'{name} du', k_du, r_du, **BWD_TOL)
    assert_close(f'{name} dm2', k_dm2, r_dm2, **BWD_TOL)
    return err


def check_conditioned(name, tied, u, m2, x, blam, dtype, rtol):
    """The kernel in `dtype` against the plain version in f64 on the headline
    operands. On the headline b_lam the trace cancels: the magnitudes of its
    terms, mag = sum_ij |blam_ij| w_ij dv_i dv_j, reach 1e3-1e6 times the
    result, so no evaluation in `dtype` (the plain version's included) meets
    a plain rtol everywhere. The bar adds 16 ulps of mag, the forward-error
    bound of a sum whose terms each carry a few ulps:
    |k - r64| <= rtol |r64| + 16 eps mag. Returns the max abs errors of the
    kernel and of the plain version in `dtype`, both against f64, and the
    kernel's largest |k - r64| / mag."""
    import torch
    fn, ref = trace_fns(tied)
    cast = lambda t: t.to(dtype)
    r64 = ref(u, m2, x, blam)
    mag = ref(u, m2, x, blam.abs())
    k = fn(cast(u), cast(m2), cast(x), cast(blam)).double()
    p = ref(cast(u), cast(m2), cast(x), cast(blam)).double()
    err = (k - r64).abs()
    eps = torch.finfo(dtype).eps
    bound = rtol * r64.abs() + 16 * eps * mag
    if not bool((err <= bound).all()):
        raise AssertionError(f'{name}: |k - r64| exceeds {rtol} |r64| + 16 eps '
                             f'mag by up to {float((err / bound).max()):.3f}x')
    return float(err.max()), float((p - r64).abs().max()), float((err / mag).max())


def phase_kernels(dev, b, n_ragged, cache):
    """Phase 3: each kernel against its plain version. At the headline shape
    and at a ragged one (N not a multiple of the 128-row block), with the JAX
    kernel test's inputs and bars; then on the headline GP's own operands.
    Returns {kernel: max abs forward error at the JAX test's bar}."""
    import torch
    rng = np.random.default_rng(0)
    n, d = cache.x.shape
    e = cache.b_lam.shape[0]
    out = {}
    for tied, key in ((True, 'K1'), (False, 'K2')):
        err = check_trace(f'{key} headline shape', tied,
                          *kernel_test_inputs(rng, b, n, d, e, tied, dev))
        err_r = check_trace(f'{key} ragged B=7 N={n_ragged}', tied,
                            *kernel_test_inputs(rng, 7, n_ragged, d, e, tied,
                                                dev))
        out[key] = max(err, err_r)
        log(f'[kernels] {key} f32 vs plain f64, B={b} N={n} and B=7 '
            f'N={n_ragged}: max abs err {err:.3e} / {err_r:.3e} (fwd rtol '
            f'5e-5 atol 5e-5, bwd rtol 2e-3 atol 2e-4) ok')
        # The f64 instance serves the reference objective on the card.
        for dtype, rtol in ((torch.float32, 5e-5), (torch.float64, 1e-12)):
            k_max, p_max, k_mag = check_conditioned(
                f'{key} headline operands {dtype}', tied,
                *headline_inputs(rng, b, cache, dev, tied), dtype, rtol)
            log(f'[kernels] {key} in {dtype} on the headline x and b_lam vs '
                f'plain f64: max abs err {k_max:.3e} (at most {k_mag:.3e} of '
                f'the terms\' magnitude sum; the plain version in {dtype}: '
                f'{p_max:.3e}); bar {rtol} |t| + 16 eps mag ok')
    return out


def time_kernels(dev, b, cache, reps):
    """Phase 3, timing at the headline shape: each wrapper (CUDA kernel)
    beside its plain PyTorch version on the same f32 inputs."""
    import torch
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    rng = np.random.default_rng(1)
    e, n, d = cache.b_lam.shape[0], cache.x.shape[0], cache.x.shape[1]
    f32 = lambda t: t.to(torch.float32).contiguous()
    u, m2, x, _ = headline_inputs(rng, b, cache, dev, True)
    a, g, dv = vt._prep_tied(f32(u), f32(m2), f32(x))
    aod = vt._aug(a) * dv[..., None]
    k1 = [f32(t) for t in (g, dv, a, aod, cache.b_lam)]
    uu, m2u, xu, _ = headline_inputs(rng, b, cache, dev, False)
    au, gu, dvu = vt._prep_batched(f32(uu), f32(m2u), f32(xu))
    k2 = [f32(t) for t in (gu, dvu, au, vt._aug(au), cache.b_lam)]
    res = {
        'K1': dict(ms=cuda_ms(lambda: vt.rw_tied(*k1), reps),
                   plain_ms=cuda_ms(lambda: vt.rw_tied_reference(*k1), reps),
                   bound=bound_ms(b, n, n, d, e, chains=1)),
        'K2': dict(ms=cuda_ms(lambda: vt.rw_untied(*k2), reps),
                   plain_ms=cuda_ms(lambda: vt.rw_untied_reference(*k2), reps),
                   bound=bound_ms(b, n, n, d, e, chains=e)),
    }
    for key, r in res.items():
        log(f'[kernels] {key} at B={b} N={n} d={d} E={e}: {r["ms"]:.4f} ms, '
            f'plain {r["plain_ms"]:.4f} ms, bound {r["bound"][0]:.4f} ms '
            f'({r["bound"][1]})')
    return res


def phase_objective(dev, ref, b):
    """Phase 4: the port's f64 objective vs the JAX package's. Returns the
    f64 objective and its values at u_ref."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    from gpmpc_tpu_torch.problems import make_headline_problem
    f64 = torch.float64
    p64 = make_headline_problem(b=b, dtype=f64, device=dev)
    j64 = batch_objective(build_rollout_cache(p64.gp, 2, 1), p64.x0s, p64.params)
    u_ref = torch.tensor(ref['u_ref'][:b], dtype=f64, device=dev)
    with torch.no_grad():
        j_uref = j64(u_ref)
    u0 = torch.zeros_like(u_ref, requires_grad=True)
    j_zero = j64(u0)
    n_grad = min(b, ref['grad_zero'].shape[0])
    (g_zero,) = torch.autograd.grad(j_zero[:n_grad].sum(), u0)
    assert_close('J64(u_ref)', j_uref, torch.tensor(ref['j_uref'][:b]),
                 rtol=OBJ_RTOL, atol=0.0)
    assert_close('J64(0)', j_zero, torch.tensor(ref['j_zero'][:b]),
                 rtol=OBJ_RTOL, atol=0.0)
    assert_close('dJ64/du at 0', g_zero[:n_grad],
                 torch.tensor(ref['grad_zero'][:n_grad]), rtol=OBJ_RTOL,
                 atol=1e-10)
    rel_uref = np.max(np.abs(j_uref.cpu().numpy() / ref['j_uref'][:b] - 1))
    rel_zero = np.max(np.abs(j_zero.detach().cpu().numpy() / ref['j_zero'][:b] - 1))
    log(f'[objective] f64 J at u_ref and 0, B={b}: max rel err vs JAX '
        f'{rel_uref:.2e} / {rel_zero:.2e} (rtol {OBJ_RTOL}) ok')

    p32 = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    j32 = batch_objective(build_rollout_cache(p32.gp, 2, 1), p32.x0s, p32.params)
    with torch.no_grad():
        rel = (j32(u_ref.float()).double() - j_uref).abs() / j_uref.abs()
    rel = rel.cpu().numpy()
    log(f'[objective] f32 J at u_ref vs f64: rel err p50 '
        f'{np.median(rel):.3e}, max {rel.max():.3e}')
    return j64, j_uref, dict(f32_rel_err_p50=float(np.median(rel)),
                             f32_rel_err_max=float(rel.max()))


def phase_solve(dev, b, j64, j_uref, reps):
    """Phase 5: the main path, counted, then timed and scored."""
    import torch
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from gpmpc_tpu_torch.parallel.batch import batch_objective, solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=ITERS, tol=1e-4)
    j32 = batch_objective(build_rollout_cache(p.gp, 2, 1), p.x0s, p.params)
    u_init = torch.zeros((b, p.horizon, 1), dtype=torch.float32, device=dev)
    with torch.no_grad():
        cost0 = j32(u_init)

    def solve(x0s):
        return solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                           cfg)

    vt.LAUNCHES = vt.LAUNCHES_UNTIED = 0
    res = solve(p.x0s)
    sync(dev)
    launches, launches_untied = vt.LAUNCHES, vt.LAUNCHES_UNTIED
    loop_iters = int(res.iters.max())
    cost = res.cost
    if not bool(torch.isfinite(cost).all()):
        raise AssertionError('solve: non-finite costs')
    # The Armijo test admits f_try <= f + eps_f with eps_f = 16 eps (1 + |f|),
    # so a lane may end up to iters * eps_f above its start and no further.
    slack = loop_iters * 16 * torch.finfo(torch.float32).eps * (1 + cost0.abs())
    worse = int((cost > cost0 + slack).sum())
    if worse:
        raise AssertionError(f'solve: {worse} lanes end above their start')
    expect = p.horizon * (1 + loop_iters)
    if launches != expect or launches_untied != 0:
        raise AssertionError(f'solve: {launches} K1 launches '
                             f'({launches_untied} K2), expected H*(1+iters) = '
                             f'{expect}')
    log(f'[solve] B={b} H={p.horizon} max_iters={ITERS}: loop iterations '
        f'{loop_iters}, K1 launches {launches} = H*(1+iters) ok; costs finite, '
        f'none above its start ok; mean cost {float(cost.mean()):.4f} vs '
        f'{float(cost0.mean()):.4f} at u=0')

    with torch.no_grad():
        j_sol = j64(res.u.double())
    excess = ((j_sol - j_uref) / (1 + j_uref.abs())).cpu().numpy()
    quality = dict(p50=float(np.percentile(excess, 50)),
                   p90=float(np.percentile(excess, 90)),
                   max=float(excess.max()),
                   lanes_above_1pct=int((excess > 0.01).sum()))
    log(f'[solve] cost excess vs f64 u_ref (J64): p50 {quality["p50"]:.4%} '
        f'p90 {quality["p90"]:.4%} max {quality["max"]:.4%}, lanes >1% '
        f'{quality["lanes_above_1pct"]}/{b}')

    rng = np.random.default_rng(123)
    walls, iters = [], []
    for _ in range(reps):
        x0s = torch.tensor(rng.uniform(-1, 1, (b, 2)), dtype=torch.float32,
                           device=dev)
        sync(dev)
        t0 = time.perf_counter()
        r = solve(x0s)
        sync(dev)
        walls.append(time.perf_counter() - t0)
        iters.append(int(r.iters.max()))
    rate = [b / w for w in walls]
    log(f'[solve] wall s per batch {[round(w, 4) for w in walls]}, loop '
        f'iterations {iters}; solves/s median {float(np.median(rate)):.2f}')
    return dict(launches=launches, loop_iters=loop_iters, quality=quality,
                walls=walls, solves_per_s=float(np.median(rate)),
                iters_timed=iters)


def phase_untied(dev, b):
    """Phase 5b: the untied path (per-output lengthscales) runs K2."""
    import torch
    from gpmpc_tpu_torch.gp.state import make_gp
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    gp = p.gp
    n = int(gp.count)
    ll = np.log([[4.0, 4.0, 4.0], [3.0, 5.0, 4.0]])
    gp = make_gp(gp.config, gp.x[:n].cpu().numpy(), gp.y[:, :n].T.cpu().numpy(),
                 log_lambdas=ll, log_sigma_f=0.0, log_sigma_n=np.log(0.1),
                 dtype=torch.float32, device=dev)
    assert not gp.config.tied_lambdas
    vt.LAUNCHES = vt.LAUNCHES_UNTIED = 0
    res = solve_batch(gp, 2, 1, p.x0s, p.params, p.horizon, p.lb, p.ub,
                      SolverConfig(max_iters=UNTIED_ITERS, tol=1e-4))
    sync(dev)
    loop_iters = int(res.iters.max())
    expect = 2 * p.horizon * (1 + loop_iters)
    if vt.LAUNCHES_UNTIED != expect or vt.LAUNCHES != 0:
        raise AssertionError(f'untied solve: {vt.LAUNCHES_UNTIED} K2 launches, '
                             f'{vt.LAUNCHES} K1, expected E*H*(1+iters) = '
                             f'{expect}')
    if not bool(torch.isfinite(res.cost).all()):
        raise AssertionError('untied solve: non-finite costs')
    log(f'[untied] B={b} max_iters={UNTIED_ITERS}: loop iterations '
        f'{loop_iters}, K2 launches {vt.LAUNCHES_UNTIED} = E*H*(1+iters) ok')
    return vt.LAUNCHES_UNTIED


def phase_profile(dev, b, out_dir):
    """One headline solve under torch.profiler: device busy time, K1's share,
    and the number of device kernels. The table goes to `out_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=ITERS, tol=1e-4)
    solve_batch(p.gp, 2, 1, p.x0s, p.params, p.horizon, p.lb, p.ub, cfg)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_batch(p.gp, 2, 1, p.x0s, p.params, p.horizon, p.lb, p.ub, cfg)
        sync(dev)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == 'CUDA']
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    k1_us = sum(e.time_range.elapsed_us() for e in events
                if 'rw_tied_kernel' in e.name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke_profile.txt'), 'w') as f:
        f.write(prof.key_averages().table(sort_by='self_device_time_total',
                                          row_limit=40))
    if busy_us == 0:
        log('[profile] device time: not measured (the profiler saw no '
            'device events)')
        return None
    prof_d = dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                  device_kernels=len(events), k1_s=k1_us / 1e6)
    log(f'[profile] one solve under the profiler: wall {wall:.4f} s, device '
        f'busy {busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / wall:.1f}%), '
        f'{len(events)} device kernels, K1 {k1_us / 1e6:.4f} s '
        f'({100 * k1_us / max(busy_us, 1):.1f}% of busy)')
    return prof_d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'chip_smoke_out'),
                    help='directory for the run summary and the profiler '
                         'table')
    out_dir = ap.parse_args().out
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 2
    from gpmpc_tpu_torch.device import resolve_device
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.ops.kernels import _build
    from gpmpc_tpu_torch.problems import make_headline_problem

    t_start = time.perf_counter()
    dev = resolve_device('cuda')
    card = card_line()
    props = torch.cuda.get_device_properties(dev)
    clock = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                            '--format=csv,noheader,nounits'],
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.strip().splitlines()[0]
    log(f'[device] {card}; {props.multi_processor_count} SMs, max SM clock '
        f'{clock} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}')

    log(f'[build] nvcc built the kernels in {_build.build_all():.1f} s')

    b = 256
    cache = build_rollout_cache(
        make_headline_problem(b=b, dtype=torch.float32, device=dev).gp, 2, 1)
    checks = phase_kernels(dev, b, 200, cache)
    times = time_kernels(dev, b, cache, reps=50)
    k1_instr = instr_bound_ms(b, cache.x.shape[0], 3, cache.b_lam.shape[0],
                              props, float(clock))
    log(f'[kernels] K1 instruction-rate estimate from {props.multi_processor_count}'
        f' SMs x 128 lanes at {clock} MHz: {k1_instr:.4f} ms')

    ref = np.load(REF)
    j64, j_uref, obj = phase_objective(dev, ref, b)
    solve = phase_solve(dev, b, j64, j_uref, reps=3)
    untied_launches = phase_untied(dev, b)
    prof = phase_profile(dev, b, out_dir)

    kernels = []
    for key, fn, line, launches in (
            ('K1', 'rw_tied (variance_trace_batched_tied)', 638,
             solve['launches']),
            ('K2', 'rw_untied (variance_trace_batched)', 214, untied_launches)):
        t = times[key]
        kernels.append(dict(
            name=f'{key} {fn}', route='cuda', source=SOURCE,
            replaces=f'{TPU_FILE}:{line}', launches=launches,
            max_abs_err=checks[key], ms=t['ms'], plain_ms=t['plain_ms'],
            bound_ms=t['bound'][0], bound_by=t['bound'][1], library_ms=None))
    detail = dict(objective=obj, solve=solve, profile=prof,
                  k1_instr_bound_ms=k1_instr,
                  total_s=time.perf_counter() - t_start)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
        json.dump(dict(card=card, kernels=kernels, **detail), f, indent=1)
    log(f'[output] total {detail["total_s"]:.1f} s')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
