"""The import rule: no file the benchmark runs imports JAX or the JAX
package (top-level names compared whole: gpmpc_tpu_torch, the program,
begins with gpmpc_tpu) or reads the JAX package's benchmarks (benchmarks/,
bench.py); the reference imports nothing of the program either."""

from __future__ import annotations

import ast
import os

import pytest

from portbench.tests.conftest import ROOT

PB = os.path.join(ROOT, 'portbench')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'gpmpc_tpu'}
JAX_BENCH = ('benchmarks', 'bench.py', 'bench')


def _run_files():
    """Every Python file under portbench/ that a run can load (its tests
    excepted: they may import both sides)."""
    out = []
    for base, dirs, files in os.walk(PB):
        dirs[:] = [d for d in dirs if d not in ('tests', '__pycache__',
                                                '_cache')]
        out += [os.path.join(base, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _imports(path):
    """(top-level module names imported, string constants) of a file."""
    tree = ast.parse(open(path).read(), path)
    names, strings = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.add(node.value)
    return names, strings


def _reads_jax_bench(strings) -> bool:
    for s in strings:
        parts = s.replace('\\', '/').split('/')
        if parts[0] in JAX_BENCH and len(s) < 120 and ' ' not in s:
            return True
        if s.startswith(('benchmarks.', 'bench.')) and ' ' not in s:
            return True
    return False


@pytest.mark.parametrize('path', _run_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_no_jax_benchmarks(path):
    names, strings = _imports(path)
    assert not names & FORBIDDEN, f'{path} imports {names & FORBIDDEN}'
    assert not _reads_jax_bench(strings), f'{path} names benchmarks/'
    rel = os.path.relpath(path, PB)
    if rel.startswith('reference' + os.sep):
        assert 'gpmpc_tpu_torch' not in names, f'{path} imports the program'


def test_rule_compares_whole_names(tmp_path):
    """gpmpc_tpu_torch passes, gpmpc_tpu and jax.numpy fail."""
    f = tmp_path / 'x.py'
    f.write_text('import gpmpc_tpu_torch.gp\nfrom jax import numpy\n'
                 'import gpmpc_tpu.ops\n')
    names, _ = _imports(str(f))
    assert names & FORBIDDEN == {'jax', 'gpmpc_tpu'}
    assert _reads_jax_bench({'benchmarks/problems.py'})
    assert not _reads_jax_bench({'portbench/work'})
