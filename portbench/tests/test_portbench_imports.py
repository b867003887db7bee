"""Nothing under portbench/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and a run without a card prints
no result."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "hippomm_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources():
    for root, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}
    assert "hippomm_tpu" != "hippomm_tpu_torch".split(".", 1)[0]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert not set(_imports(os.path.join(ref, f))) & (FORBIDDEN | {"hippomm_tpu_torch", "portbench"})


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ingest-vlog-bf16", "--seed",
                        str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


def test_run_imports_no_forbidden_module():
    code = ("import sys; sys.argv=['x']; sys.path.insert(0, %r); import portbench.run as r; "
            "import portbench.harness.ingest, portbench.harness.check; "
            "print(r.forbidden_modules())" % REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.stdout.strip() == "[]", p.stderr
