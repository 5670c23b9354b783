"""The card test files stay runnable where there is no JAX.

The machine with the CUDA card has no JAX, so ``tests/test_torch_*_card.py``,
the graph paths' files (``test_torch_adam_graph.py``,
``test_torch_gen_dst_graph.py``), ``tests/_card.py`` and every helper
module of ``tests/`` that they import must import nothing of ``jax``, of the
reference package (``repro``) or of ``tests/_torch_port.py`` (which imports
``jax``).  Checked by parsing the
sources, without importing them.
"""
import ast
from pathlib import Path

TESTS = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "repro", "_torch_port")


def _imports(path):
    """(line, module) of every import statement in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_card_files_import_no_jax_and_no_reference():
    todo = sorted(TESTS.glob("test_torch_*_card.py")) + [
        TESTS / name for name in ("test_torch_adam_graph.py", "test_torch_gen_dst_graph.py",
                                  "_card.py")]
    assert len(todo) > 1
    seen, bad = set(), []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for line, module in _imports(path):
            root = module.split(".")[0]
            if root in FORBIDDEN:
                bad.append(f"{path.name}:{line}: {module}")
            elif root.startswith("_") and (TESTS / f"{root}.py").exists():
                todo.append(TESTS / f"{root}.py")
    assert not bad, bad
