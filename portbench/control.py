"""The control of a cell's judgement: the program with its own path one
precision below the configuration's switched on, whose run has to come
out not correct. The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

A cell's workload file names its control:
  "trace_f32"    every variance trace evaluated in f32
                 (ops/kernels/variance_trace.py's TRACE_DTYPE, the
                 precision policy, set to float32; the configuration
                 states f64 traces);
  "storage_f32"  the GP's data and cached fit, the states and the controls
                 stored in f32 where the configuration states f64 (the
                 fits and traces stay f64).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, root: str = ROOT, require_cuda: bool = True,
         out=None, err=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
    from portbench import run
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument('--workload', required=True)
    args, rest = ap.parse_known_args(
        list(sys.argv[1:] if argv is None else argv))
    rest += ['--workload', args.workload, '--trace', '0']
    kind = run.Cell(args.workload, root).workload['control']
    kw = dict(root=root, require_cuda=require_cuda, t_start=T_START,
              out=out, err=err)
    if kind == 'storage_f32':
        def f32_storage(config):
            config['precision'] = dict(config['precision'],
                                       storage='float32')
        return run.run(rest, config_tweak=f32_storage, **kw)
    policy, vt.TRACE_DTYPE = vt.TRACE_DTYPE, torch.float32
    try:
        return run.run(rest, **kw)
    finally:
        vt.TRACE_DTYPE = policy


if __name__ == '__main__':
    sys.exit(main())
