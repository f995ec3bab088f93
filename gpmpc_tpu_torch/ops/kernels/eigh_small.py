"""The batched small symmetric eigensolver and its CUDA kernel.

`eigh(a)` takes symmetric (..., d, d) matrices, d <= MAX_D, and returns
(w, v) as torch.linalg.eigh and jnp.linalg.eigh do: the eigenvalues
ascending (..., d) and orthonormal eigenvectors in the columns of
v (..., d, d). The full-covariance rollout's PSD clip (dynamics._psd_clip)
calls it once a step, where the JAX package calls jnp.linalg.eigh
(gpmpc_tpu/dynamics.py:164, 312; XLA's, not a Pallas kernel). Unlike
torch.linalg.eigh, whose error check waits on the host, it reads nothing
back, so a step that calls it can be captured in a CUDA graph.

The method is the cyclic Jacobi method with Rutishauser's stable rotation,
one thread a matrix (csrc/eigh_small.cu, whose note gives the rotation, the
skip rule, the sweep cap and the bound). CUDA tensors launch the kernel's
instance of their dtype (f32 or f64, each computing in its own dtype); CPU
tensors take the plain version `eigh_reference`, the same operations as
torch ops, one lane of the batch each lane of the kernel, so that the two
agree to the bit. There is no fallback from one to the other.

The gradient is JAX's: the transpose of `eigh_jvp_rule`,
G = V (diag(gw) + F o (V^T gV)) V^T with F_ij = 1 / (w_j - w_i) off the
diagonal and 0 on it, taken back through the input's symmetrisation
(jnp.linalg.eigh symmetrises its input): gA = (G + G^T) / 2. Torch ops, no
host read and no kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gpmpc_tpu_torch.ops.kernels import _build
from gpmpc_tpu_torch.utils import replay_counts

MAX_D = 8
SWEEPS = 15             # kSweeps of csrc/eigh_small.cu
THREADS = 128           # kThreads: matrices a block, one a thread
_LIB = 'eigh_small'
_FN = {torch.float32: 'gpmpc_eigh_small_f32',
       torch.float64: 'gpmpc_eigh_small_f64'}

# Kernel launches, counted where they happen; a launch captured in a CUDA
# graph counts once per replay, by the graph's own kernel nodes
# (utils/replay_counts.py).
LAUNCHES_EIGH = 0


def _add_launches(delta) -> None:
    global LAUNCHES_EIGH
    LAUNCHES_EIGH += delta.get('LAUNCHES_EIGH', 0)


def graph_counters(name: str) -> tuple:
    """The counters that a launch of the kernel function `name` (mangled or
    not) counts in: this module's kernel LAUNCHES_EIGH, any other ()."""
    return ('LAUNCHES_EIGH',) if 'eigh_small_kernel' in name else ()


replay_counts.register_kernels(lambda: {'LAUNCHES_EIGH': LAUNCHES_EIGH},
                               _add_launches, graph_counters)


def _check_d(d: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f'eigh_small takes (..., d, d) matrices with '
                         f'1 <= d <= {MAX_D}; got d={d}')


# --------------------------------------------------- the plain version --
def _rotate(a, v, p, q, eps, live):
    """Rotation (p, q) of every lane of the batch where `live` (lanes whose
    sweeps go on) and |a_pq| passes the skip rule; the others keep their
    bits. a, v are lists of lists of (n,) tensors, a symmetric (a[i][j] is
    a[j][i]). Returns the lanes it rotated."""
    apq, app, aqq = a[p][q], a[p][p], a[q][q]
    tol = eps * (torch.sqrt(torch.abs(app)) * torch.sqrt(torch.abs(aqq)))
    rot = (torch.abs(apq) > tol) & live
    theta = (aqq - app) / (apq + apq)
    t = torch.reciprocal(torch.abs(theta)
                         + torch.sqrt(1.0 + theta * theta))
    t = torch.where(theta < 0.0, -t, t)
    c = torch.reciprocal(torch.sqrt(1.0 + t * t))
    s = t * c
    tau = s / (1.0 + c)
    h = t * apq

    def keep(new, old):
        return torch.where(rot, new, old)

    a[p][p] = keep(app - h, app)
    a[q][q] = keep(aqq + h, aqq)
    a[p][q] = a[q][p] = keep(torch.zeros_like(apq), apq)
    d = len(a)
    for r in range(d):
        if r in (p, q):
            continue
        arp, arq = a[r][p], a[r][q]
        a[r][p] = a[p][r] = keep(arp - s * (arq + tau * arp), arp)
        a[r][q] = a[q][r] = keep(arq + s * (arp - tau * arq), arq)
    for r in range(d):
        vrp, vrq = v[r][p], v[r][q]
        v[r][p] = keep(vrp - s * (vrq + tau * vrp), vrp)
        v[r][q] = keep(vrq + s * (vrp - tau * vrq), vrq)
    return rot


def eigh_reference(a):
    """Plain version of the kernel: symmetric (..., d, d) -> (w (..., d)
    ascending, v (..., d, d)), the kernel's operations in its order, as
    torch ops over the flattened batch. A lane stops rotating after a
    sweep that rotated nothing (the kernel's thread stops there; later
    sweeps would change nothing); the loop ends when every lane has, or
    after SWEEPS sweeps."""
    return _jacobi(a)[:2]


def work(a) -> tuple:
    """(rotations, pair visits) that the kernel makes on a, summed over the
    batch, counted by the plain version: a sweep visits every pair p < q
    (its skip test) and rotates those that pass it."""
    _, _, rotations, sweeps = _jacobi(a)
    d = a.shape[-1]
    return int(rotations), int(sweeps) * d * (d - 1) // 2


def _jacobi(a):
    """eigh_reference's (w, v), and the rotations and sweeps its lanes ran
    (0-dim tensors)."""
    d = a.shape[-1]
    _check_d(d)
    if a.shape[-2] != d:
        raise ValueError(f'eigh_small takes square matrices, got '
                         f'{tuple(a.shape)}')
    lead = a.shape[:-2]
    flat = a.reshape(-1, d, d)
    n = flat.shape[0]
    eps = torch.finfo(a.dtype).eps
    m = [[flat[:, i, i] if i == j else 0.5 * (flat[:, i, j] + flat[:, j, i])
          for j in range(d)] for i in range(d)]
    one, zero = torch.ones_like(flat[:, 0, 0]), torch.zeros_like(flat[:, 0, 0])
    v = [[one if i == j else zero for j in range(d)] for i in range(d)]
    live = torch.ones((n,), dtype=torch.bool, device=a.device)
    rotations = sweeps = torch.zeros((), dtype=torch.long, device=a.device)
    for _ in range(SWEEPS):
        rotated = torch.zeros_like(live)
        sweeps = sweeps + live.sum()
        for p in range(d - 1):
            for q in range(p + 1, d):
                rot = _rotate(m, v, p, q, eps, live)
                rotations = rotations + rot.sum()
                rotated = rotated | rot
        live = rotated
        if not bool(live.any()):
            break
    w = torch.stack([m[i][i] for i in range(d)], dim=-1)       # (n, d)
    vm = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    w, order = torch.sort(w, dim=-1, stable=True)
    vm = torch.gather(vm, -1, order[:, None, :].expand(n, d, d))
    return w.reshape(*lead, d), vm.reshape(*lead, d, d), rotations, sweeps


# ------------------------------------------------------------ the kernel --
def _kernel_fn(dtype):
    """(launch, error string) of the library's `dtype` instance; the
    library's constants are checked against this module's at first load."""
    lib = _build.load(_LIB)
    fn = getattr(lib, _FN[dtype])
    if fn.argtypes is None:
        for name, want in (('max_d', MAX_D), ('sweeps', SWEEPS),
                           ('threads', THREADS)):
            got_fn = getattr(lib, f'gpmpc_eigh_small_{name}')
            got_fn.restype = ctypes.c_longlong
            if got_fn() != want:
                raise RuntimeError(f'gpmpc_eigh_small_{name} is {got_fn()} '
                                   f'in the compiled kernel, {want} here')
        err = lib.gpmpc_eigh_small_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for f in (lib.gpmpc_eigh_small_f32, lib.gpmpc_eigh_small_f64):
            f.argtypes = ([ctypes.c_void_p] * 3
                          + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
            f.restype = ctypes.c_int
    return fn, lib.gpmpc_eigh_small_error_string


def _check(a) -> None:
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f'eigh_small takes (..., d, d) matrices, got '
                         f'{tuple(a.shape)}')
    _check_d(a.shape[-1])
    if a.dtype not in _FN:
        raise TypeError(f'eigh_small takes float32 or float64, got {a.dtype}')
    if a.device.type != 'cuda':
        raise ValueError(f'eigh_small kernel runs on CUDA tensors, got '
                         f'{a.device}')
    if not a.is_contiguous():
        raise ValueError('eigh_small kernel takes a contiguous tensor')


def launch(a):
    """Launch the kernel on the current stream: a contiguous CUDA tensor
    (..., d, d) -> (w, v, launched). Counts nothing (timing, the checks)."""
    _check(a)
    d = a.shape[-1]
    w = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
    v = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    n = a.numel() // (d * d)
    if n == 0:
        return w, v, False
    fn, err_str = _kernel_fn(a.dtype)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), w.data_ptr(), v.data_ptr(), n, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'eigh_small kernel launch failed: cudaError '
                           f'{err} ({err_str(err).decode()})')
    return w, v, True


def _forward(a):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    global LAUNCHES_EIGH
    if a.device.type == 'cpu':
        return eigh_reference(a)
    w, v, launched = launch(a)
    LAUNCHES_EIGH += launched
    return w, v


class _Eigh(torch.autograd.Function):
    """The eigensolver with JAX's gradient. Under torch.func.vmap the
    mapped axis moves to the front and one call serves every lane (the
    kernel takes (..., d, d)): the `vmap` rule, so that a lanes rollout
    launches the kernel once a step for all its lanes."""

    @staticmethod
    def forward(a):
        return _forward(a.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)

    @staticmethod
    def vmap(info, in_dims, a):
        return _Eigh.apply(a.movedim(in_dims[0], 0)), (0, 0)

    @staticmethod
    def backward(ctx, gw, gv):
        w, v = ctx.saved_tensors
        d = w.shape[-1]
        eye = torch.eye(d, dtype=w.dtype, device=w.device)
        inner = torch.zeros_like(v)
        if gv is not None:
            f = torch.reciprocal(eye + w[..., None, :] - w[..., :, None]) - eye
            inner = f * (v.transpose(-1, -2) @ gv)
        if gw is not None:
            inner = inner + torch.diag_embed(gw)
        ga = v @ inner @ v.transpose(-1, -2)
        # Through the symmetrisation of the input, as JAX's eigh.
        return 0.5 * (ga + ga.transpose(-1, -2))


def eigh(a):
    """Symmetric (..., d, d), 1 <= d <= MAX_D, f32 or f64 -> (w, v): the
    eigenvalues ascending and the orthonormal eigenvectors in v's columns.
    CUDA tensors launch the kernel, CPU tensors take `eigh_reference`;
    differentiable (JAX's eigh gradient)."""
    return _Eigh.apply(a)
