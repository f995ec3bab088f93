"""Registers, stack and local memory (spills) of every kernel the CUDA
libraries hold, read from the built libraries.

Runs `cuobjdump -res-usage` on each built `gpmpc_tpu_torch/_build/lib*.so`
(ops/kernels/_build.py builds what is missing) and demangles the names with
`cu++filt`: REG is the registers a thread, STACK and LOCAL the bytes a
thread keeps in local memory (spilled registers and arrays the compiler could
not keep in registers; 0 where nothing spills). `summary` picks the f64
instances of K1: the tensor-core body's (`rw_tied_mma_kernel`) and the
scalar body's at T = double.

Run where the CUDA toolkit is (the card's machine):

    python -m gpmpc_tpu_torch.benchmarks.res_usage [--out DIR]

It prints one JSON line a K1 f64 kernel and writes DIR/res_usage.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from pathlib import Path

from gpmpc_tpu_torch.ops.kernels import _build

_FUNCTION = re.compile(r'Function (\S+):\s*\n\s*(REG:.*)')
_FIELD = re.compile(r'([A-Z]+(?:\[\d+\])?):(\d+)')


def _tool(name: str) -> str:
    return str(Path(_build.find_nvcc()).with_name(name))


def parse(text: str) -> dict:
    """{mangled name: {REG, STACK, SHARED, LOCAL, ...}} of a -res-usage
    listing."""
    return {m.group(1): {k: int(v) for k, v in _FIELD.findall(m.group(2))}
            for m in _FUNCTION.finditer(text)}


def demangle(names) -> dict:
    names = list(names)
    out = subprocess.run([_tool('cu++filt')], input='\n'.join(names),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def library_usage(name: str) -> dict:
    """{demangled kernel name: usage} of the built library `name`."""
    text = subprocess.run([_tool('cuobjdump'), '-res-usage',
                           str(_build.library_path(name))], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    usage = parse(text)
    names = demangle(usage)
    return {names[k]: v for k, v in usage.items()}


def summary(usage: dict) -> dict:
    """The f64 instances of K1 at the headline's (d, E) = (3, 2): the
    tensor-core body's kernels (E = 2, KS = NT = 1) and the scalar body's
    at double, d = 3, E = 2."""
    pick = {}
    for lib, kernels in usage.items():
        for name, u in kernels.items():
            # cu++filt writes template arguments as (int)2, (bool)0.
            plain = re.sub(r'\((?:int|bool)\)', '', name)
            mma = 'rw_tied_mma_kernel<2, 1, 1,' in plain
            scalar = 'rw_tied_kernel<double, 3, 2,' in plain
            if mma or scalar:
                pick[f'{lib}: {plain.split("(const")[0]}'] = u
    return pick


def run() -> dict:
    _build.build_all()
    libs = sorted(p.stem for p in _build.CSRC.glob('*.cu'))
    usage = {lib: library_usage(lib) for lib in libs}
    return dict(summary=summary(usage), libraries=usage)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    res = run()
    for name, u in res['summary'].items():
        print(json.dumps({name: u}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'res_usage.json'), 'w') as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
