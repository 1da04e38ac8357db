"""Run one of the JAX package's test files on the port.

``mirror(name, namespace, drop=...)`` reads ``tests/<name>.py``, renames its
``consensus_tpu`` imports to ``consensus_tpu_torch`` (the rename the port's
copies carry), blanks the top-level statements named in ``drop`` and
executes the rest into ``namespace``: the calling test module, where pytest
then collects the same tests and fixtures, now exercising the port.  The
text keeps its line numbers and is compiled under the JAX file's path, so a
traceback points at the very line of the JAX test that failed.  ``drop``
maps each removed name (a test, a helper, or an imported module) to why the
port cannot run it yet.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def _names(node: ast.stmt) -> set[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        mod = {node.module} if isinstance(node, ast.ImportFrom) else set()
        return mod | {a.asname or a.name for a in node.names}
    if isinstance(node, ast.Assign):
        return {t.id for t in node.targets if isinstance(t, ast.Name)}
    return set()


def mirror(name: str, namespace: dict, drop: dict[str, str] | None = None) -> None:
    """Execute the JAX test file ``name`` on the port into ``namespace``."""
    path = TESTS / f"{name}.py"
    source = path.read_text()
    lines = source.splitlines(keepends=True)
    dropped = set()
    for node in ast.parse(source).body:
        hit = _names(node) & set(drop or {})
        if not hit:
            continue
        dropped |= hit
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        for i in range(first - 1, node.end_lineno):
            lines[i] = "\n"
    missing = set(drop or {}) - dropped
    assert not missing, f"{name}: nothing named {sorted(missing)} to drop"
    text = re.sub(r"\bconsensus_tpu\b", "consensus_tpu_torch", "".join(lines))
    exec(compile(text, str(path), "exec"), namespace)
