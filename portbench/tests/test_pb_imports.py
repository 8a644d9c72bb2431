"""Nothing under portbench/ imports JAX, the JAX package or chip_smoke
(top-level names compared whole), and the generator and the references
import nothing of the program under test."""

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gmr1_tpu", "chip_smoke"}
PLAIN = ("coding.py", "modem.py", "scene.py", "bank.py", "rrc.py",
         "pre.py", "check.py", "work.py", "trace.py")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files():
    for d, _sub, files in os.walk(ROOT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {(p, m) for p in _files() for m in _imports(p) if m in FORBIDDEN}
    assert not bad


def test_plain_modules_stand_alone():
    for f in PLAIN:
        assert "gmr1_tpu_torch" not in set(_imports(os.path.join(ROOT, f))), f


def test_whole_names():
    # gmr1_tpu_torch begins with gmr1_tpu and must not count as it
    assert "gmr1_tpu_torch".split(".")[0] not in FORBIDDEN
