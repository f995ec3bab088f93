"""The probes P1 and P2 of the port (ops/kernels/probe.py and
gpmpc_tpu_torch/benchmarks/) on the CPU: the plain `full` against the Pallas
K1 run interpreted (rtol 5e-5), each ablated plain variant against a numpy
f64 transcription of the JAX probe's body (rtol 1e-12), the TPU-mode plain
versions against the f64 functions they approximate, the TF32 rounding
helper, the chain step, the two entry points, the wrapper's checks and the
build's hash of the shared headers. The CUDA kernel against its plain
versions on the card is in tests/test_torch_cuda.py."""

import functools
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.ops.pallas import variance_trace as jvt
from gpmpc_tpu_torch.benchmarks import chain, kernel_ablate, kernel_probe
from gpmpc_tpu_torch.ops.kernels import _build, probe
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from torch_port_common import np_, spd, sym

torch.set_num_threads(1)


def _probe_problem(b, n, seed=0, dtype=torch.float64):
    """The TPU probes' inputs (benchmarks/kernel_ablate.py:160-164,
    kernel_probe.py:104-107): x ~ U(-3, 3), symmetric blam ~ U(-0.1, 0.1),
    M2 = 0.3 I, u ~ U(-1, 1); K1's arguments as numpy f64 and as tensors."""
    rng = np.random.default_rng(seed)
    d, e = probe.D, probe.E
    x = rng.uniform(-3, 3, (n, d))
    blam = rng.uniform(-0.1, 0.1, (e, n, n))
    blam = 0.5 * (blam + np.swapaxes(blam, 1, 2))
    u = rng.uniform(-1, 1, (b, d))
    a = u[:, None, :] - x[None]
    g = a @ (0.3 * np.eye(d))
    dv = np.exp(-0.125 * np.sum(g * a, axis=-1))
    ao = np.concatenate([np.ones((b, n, 1)), a], axis=-1)
    arrays = dict(g=g, a=a, dv=dv, ao=ao, blam=blam)
    t = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return arrays, [t(g), t(dv), t(a), t(ao * dv[..., None]), t(blam)]


def _ablate_np(variant, g, a, dv, ao, blam, tj=128):
    """numpy f64 transcription of `make_kernel`'s body
    (benchmarks/kernel_ablate.py:47-129) in the layout `call_variant` gives
    it (:131-158): g_t (B, d, N), comb = [a | ao dv] (:138), tiles of TJ
    contraction rows (grid axis 1, :141), acc (B, E, W1, N), rw_t = dv acc
    (:122-128), swapped back (:158). The exact exp and matmul stand for
    vt._exp and the bf16x3 dot. Where the card's variant defines another
    function, the transcription departs as noted at the line."""
    b, n, d = g.shape
    e, w1 = blam.shape[0], ao.shape[-1]
    g_t = np.swapaxes(g, 1, 2)
    comb = np.concatenate([a, ao * dv[..., None]], axis=-1)
    acc = np.zeros((b, e, w1, n))
    for j0 in range(0, n, tj):
        cb, bl = comb[:, j0:j0 + tj], blam[:, j0:j0 + tj]
        for k in range(b):                                 # fori_loop, :120
            c = cb[k]                                      # :57
            if variant == 'empty':                         # :59-63
                for ee in range(e):
                    # The TPU adds blam[e][0:1, :] to every column; the card
                    # to column 0 only.
                    acc[k, ee, 0] += bl[ee, 0]
                continue
            if variant == 'nop':                           # :64-67
                emat = np.broadcast_to(g_t[k, 0:1, :], (c.shape[0], n))
            else:
                p = c[:, 0:1] * g_t[k, 0:1, :]             # :69-71
                for kk in range(1, d):
                    p = p + c[:, kk:kk + 1] * g_t[k, kk:kk + 1, :]
                emat = -0.25 * p if variant == 'noexp' else np.exp(-0.25 * p)
            aod = c[:, d:]                                 # :108
            for ee in range(e):
                w = emat if variant == 'nomul' else bl[ee] * emat  # :110-113
                if variant == 'nodots':                    # :114-115
                    # The TPU adds w's first W1 rows; the card reduces all of
                    # w's rows into column 0.
                    acc[k, ee, 0] += w.sum(axis=0)
                else:
                    acc[k, ee] += aod.T @ w                # _dot3_t, :117
    return np.swapaxes(dv[:, None, None, :] * acc, 2, 3)


def test_plain_full_matches_interpreted_tpu_kernel():
    """The probe's `full` on the CPU (its plain version) against
    `_rw_call_tied`, the Pallas K1 run interpreted: f32, rtol 5e-5 (the JAX
    kernel test's bar), as tests/test_torch_variance_trace.py holds K1."""
    b, e, n, d = 2, 2, 128, 3
    rng = np.random.default_rng(2)
    u, m2, x, blam = (rng.normal(size=(b, d)), spd(rng, (b,), d),
                      rng.normal(size=(n, d)), sym(rng, e, n))
    f32 = jnp.float32
    a, g, dv = jvt._prep_tied(jnp.asarray(u, f32), jnp.asarray(m2, f32),
                              jnp.asarray(x, f32))
    rw_j = np.asarray(jvt._rw_call_tied(g, a, dv, jvt._aug(a),
                                        jnp.asarray(blam, f32)))
    at, gt, dvt = (torch.tensor(np.asarray(v), dtype=torch.float32)
                   for v in (a, g, dv))
    aod = (tvt._aug(at) * dvt[..., None]).contiguous()
    rw_t = probe.rw_probe('full', gt, dvt, at, aod,
                          torch.tensor(blam, dtype=torch.float32))
    np.testing.assert_allclose(np_(rw_t), rw_j, rtol=5e-5,
                               atol=5e-5 * np.abs(rw_j).max())


@pytest.mark.parametrize('variant', ['full', 'full_tile256', 'full_s1',
                                     'hwexp', 'noexp', 'nop', 'nodots',
                                     'nomul', 'empty', *probe.PLANS])
def test_ablated_plain_variant_matches_transcribed_tpu_probe(variant):
    """Each ablated plain variant in f64 against the numpy transcription of
    the JAX probe's body for it (hwexp: the exact exp; full_tile256: TJ =
    256, kernel_ablate.py:183-189; full_s1 and plan_*, the card's K1
    without scenario sharing or at another block shape, have no TPU
    counterpart and are held to `full`'s), at N = 200 (a ragged tile):
    rtol 1e-12, with entries that cancel held to 1e-12 of the largest."""
    arrays, args = _probe_problem(3, 200, seed=1)
    same_as_full = variant == 'full_s1' or variant in probe.PLANS
    want = _ablate_np('full' if same_as_full else variant,
                      arrays['g'], arrays['a'], arrays['dv'], arrays['ao'],
                      arrays['blam'],
                      tj=256 if variant == 'full_tile256' else probe.EMPTY_TILE)
    got = np_(probe.rw_probe_reference(variant, *args))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_tpu_mode_plain_versions_match_f64_function():
    """kernel_probe.py's modes compute K1's function (:39-80). The plain
    red_3xtf32 and tc_p (f32, TF32 emulated) within 5e-5 of the f64 full
    (the card's bar); red_tf32 within 2^-9 of the terms' magnitude sum (two
    operands rounded to TF32, each within 2^-11) and visibly rounded."""
    arrays, args64 = _probe_problem(3, 200, seed=3)
    args = [t.float() for t in args64]
    full = np_(probe.rw_probe_reference('full', *args64))
    for v in ('red_3xtf32', 'tc_p'):
        np.testing.assert_allclose(np_(probe.rw_probe_reference(v, *args)),
                                   full, rtol=5e-5, atol=5e-5, err_msg=v)
    w = np.exp(-0.25 * np.einsum('bjk,bik->bji', arrays['a'], arrays['g']))
    mag = arrays['dv'][:, None, :, None] * np.einsum(
        'eji,bji,bjc->beic', np.abs(arrays['blam']), w,
        np.abs(np_(args64[3])))
    err = np.abs(np_(probe.rw_probe_reference('red_tf32', *args)) - full)
    assert np.all(err <= 2.0 ** -9 * mag)
    assert np.max(err / mag) > 2.0 ** -16


def _tf32_np(x):
    """numpy TF32 round to nearest, ties away, on the uint32 view."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(
        np.uint32).view(np.float32)


def test_tf32_round_exact_on_tf32_values_and_ties_away():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    bits = bits[((bits >> 23) & 0xFF) != 0xFF] & np.uint32(0xFFFFE000)
    exact = torch.from_numpy(bits.view(np.float32).copy())
    assert torch.equal(probe.tf32_round(exact), exact)
    base = bits[((bits >> 23) & 0xFF) < 0xFE]
    for low, up in ((0x1000, True), (0x0FFF, False), (0x1001, True)):
        x = torch.from_numpy((base | np.uint32(low)).view(np.float32).copy())
        want = (base + np.uint32(0x2000 if up else 0)).view(np.float32)
        np.testing.assert_array_equal(np_(probe.tf32_round(x)), want)
        np.testing.assert_array_equal(np_(probe.tf32_round(x)), _tf32_np(x))
    with pytest.raises(TypeError):
        probe.tf32_round(torch.zeros(2, dtype=torch.float64))


def test_tf32_split_reconstructs_f32():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(
        np.float32)
    hi, lo = probe.tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert torch.equal(probe.tf32_round(part), part)
    recon = np_(hi).astype(np.float64) + np_(lo).astype(np.float64)
    x64 = x.astype(np.float64)
    assert np.all(np.abs(recon - x64) <= 2.0 ** -22 * np.abs(x64))


def test_chain_step_matches_transcribed_tpu_chain():
    """Two steps of the chain (benchmarks/kernel_ablate.py:167-176) in f64
    through the plain full against numpy."""
    arrays, _ = _probe_problem(4, 40, seed=6)
    rng = np.random.default_rng(7)
    x = rng.uniform(-3, 3, (40, 3))
    u0 = rng.uniform(-1, 1, (4, 3))
    m2 = 0.3 * np.eye(3)
    blam = arrays['blam']
    t64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    step = chain.chain_step(
        lambda *args: probe.rw_probe_reference('full', *args), t64(x),
        t64(m2), t64(blam))
    got = step(step(t64(u0)))
    u = u0
    for _ in range(2):
        a = u[:, None, :] - x[None]
        g = a @ m2
        dv = np.exp(-0.125 * np.sum(g * a, axis=-1))
        ao = np.concatenate([np.ones(a.shape[:-1] + (1,)), a], axis=-1)
        t = _ablate_np('full', g, a, dv, ao, blam)[..., 0].sum(-1)
        u = u + 1e-4 * np.pad(t, ((0, 0), (0, 1)))
    np.testing.assert_allclose(np_(got), u, rtol=1e-12)


def test_kernel_ablate_runs_on_cpu():
    """B = 4, N = 32 (one ragged tile): every ablation variant reported,
    within its bar, with finite (meaningless) times."""
    res = kernel_ablate.run(device='cpu', b=4, n=32)
    assert set(res['variants']) == set(kernel_ablate.ABLATE)
    for row in res['variants'].values():
        assert np.isfinite(row['kernel_us']) and np.isfinite(row['chain_us'])
        assert row['bar_ratio'] <= 1.0
    assert res['device'] == 'cpu' and 'not a device time' in \
        res['kernel']['timer']


def test_kernel_ablate_f64_runs_on_cpu(tmp_path, monkeypatch):
    """P1 at f64 through main() (--dtype float64 --b 4, N = 32): the f64
    variants (the scalar body's stages and the tensor-core body's) in the
    JSON named for the dtype and B, each within its f64 bar (the plain
    versions on the CPU)."""
    monkeypatch.setattr(sys, 'argv', ['kernel_ablate', '--out', str(tmp_path),
                                      '--dtype', 'float64', '--b', '4'])
    monkeypatch.setattr(kernel_ablate, 'run', functools.partial(
        kernel_ablate.run, device='cpu', n=32))
    assert kernel_ablate.main(kernel_ablate.run) == 0
    res = json.loads((tmp_path / 'kernel_ablate_f64_b4.json').read_text())
    assert set(res['variants']) == set(probe.F64_VARIANTS)
    assert res['dtype'] == 'torch.float64'
    for row in res['variants'].values():
        assert np.isfinite(row['kernel_us']) and row['bar_ratio'] <= 1.0


def test_kernel_probe_runs_on_cpu(tmp_path, monkeypatch):
    """The P2 entry point through main(): every mode and its variant in the
    JSON under --out; the trace errors finite. Together with the ablation
    test, every variant of the probe is driven."""
    monkeypatch.setattr(sys, 'argv', ['kernel_probe', '--out', str(tmp_path)])
    small = functools.partial(kernel_probe.run, device='cpu', b=4, n=32)
    assert kernel_ablate.main(small, 'kernel_probe') == 0
    res = json.loads((tmp_path / 'kernel_probe.json').read_text())
    assert res['card'] == 'cpu'
    assert set(res['variants']) == set(kernel_probe.MODES)
    assert ({r['variant'] for r in res['variants'].values()}
            | set(kernel_ablate.ABLATE)) == set(probe.VARIANTS)
    for row in res['variants'].values():
        assert np.isfinite(row['t_rel_err_probe_inputs'])
        assert np.isfinite(row['t_rel_err_headline'])


def _args(b=2, n=8, d=3, e=2, dtype=torch.float32):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return [z(b, n, d), z(b, n), z(b, n, d), z(b, n, d + 1), z(e, n, n)]


@pytest.mark.parametrize('case', ['variant', 'd4', 'e3', 'f64', 'shape'])
def test_rw_probe_rejects_what_it_is_not_built_for(case):
    """On the CPU too: an unknown variant, d != 3, E != 2, float64 for a
    variant built at float32 only (hwexp), a wrong shape. Nothing is
    counted."""
    variant, args, err = 'full', _args(), ValueError
    if case == 'variant':
        variant = 'fast'
    elif case == 'd4':
        args = _args(d=4)
    elif case == 'e3':
        args = _args(e=3)
    elif case == 'f64':
        variant, args, err = 'hwexp', _args(dtype=torch.float64), TypeError
    else:
        args[3] = torch.zeros(2, 8, 3)
    before = probe.LAUNCHES_PROBE
    with pytest.raises(err):
        probe.rw_probe(variant, *args)
    assert probe.LAUNCHES_PROBE == before


def test_plain_versions_reject_unknown_variant_and_tf32_on_f64():
    with pytest.raises(ValueError):
        probe.rw_probe_reference('fast', *_args())
    with pytest.raises(TypeError):
        probe.rw_probe_reference('red_tf32', *_args(dtype=torch.float64))


def test_cpu_path_takes_plain_version_and_counts_nothing():
    _, args = _probe_problem(2, 16, seed=8, dtype=torch.float32)
    before = probe.LAUNCHES_PROBE
    for v in probe.VARIANTS:
        assert torch.equal(probe.rw_probe(v, *args),
                           probe.rw_probe_reference(v, *args))
    assert probe.LAUNCHES_PROBE == before


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited .cuh renames the library of every .cu (a stale build is
    never loaded); restoring it restores the name."""
    (tmp_path / 'k.cu').write_text('#include "body.cuh"\n')
    header = tmp_path / 'body.cuh'
    header.write_text('// v1\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    first = _build.library_path('k')
    header.write_text('// v2\n')
    assert _build.library_path('k') != first
    header.write_text('// v1\n')
    assert _build.library_path('k') == first
    (tmp_path / 'other.cuh').write_text('\n')
    assert _build.library_path('k') != first


def _fake_nvcc(tmp_path, monkeypatch, body):
    """A CUDA_HOME whose bin/nvcc runs `body` (sh) with the library path
    after -o as $out; csrc and the build directory under tmp_path."""
    nvcc = tmp_path / 'cuda' / 'bin' / 'nvcc'
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'out="$2"\n{body}\n')
    nvcc.chmod(0o755)
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    for name in ('a', 'b'):
        (csrc / f'{name}.cu').write_text(f'// {name}\n')
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'cuda'))
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')


def test_build_all_builds_each_source_once_and_times_it(tmp_path,
                                                        monkeypatch):
    """Every source is built side by side into its hashed library, with
    each one's seconds; a second call finds them built and builds none."""
    _fake_nvcc(tmp_path, monkeypatch, 'sleep 0.2; echo built > "$out"')
    total, each = _build.build_all()
    assert set(each) == {'a', 'b'}
    assert all(0.0 <= s <= total + 1.0 for s in each.values())
    for name in ('a', 'b'):
        assert _build.library_path(name).read_text() == 'built\n'
    assert sorted(p.name for p in (tmp_path / 'build').iterdir()) == sorted(
        _build.library_path(name).name for name in ('a', 'b'))
    assert _build.build_all()[1] == {}


def test_build_all_raises_with_nvcc_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo "error: bad kernel"; exit 2')
    with pytest.raises(RuntimeError, match='bad kernel'):
        _build.build_all()
    assert not any(_build.library_path(n).exists() for n in ('a', 'b'))
