"""The benchmark's import rule: nothing it runs loads JAX or the JAX
package, and the plain reference loads nothing of the program either.

Names are compared by their top-level part (before the first dot) as a
whole string: ``numbskull_tpu_torch`` begins with ``numbskull_tpu`` and
is not it.
"""

from __future__ import annotations

import ast
import os

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "numbskull_tpu"})
#: what the reference files may not import besides
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"numbskull_tpu_torch"}


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules) -> list:
    """The forbidden top-level names among loaded ``modules`` names."""
    return sorted({top(m) for m in modules} & FORBIDDEN)


def imports_of(path: str) -> set:
    """Top-level names of every module a Python file imports (absolute
    imports; a relative import names the benchmark's own package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(top(node.module) if node.level == 0 and node.module
                      else "gibbsbench")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(top(node.args[0].value))
    return names


def violations(root: str) -> list:
    """(file, name) for each forbidden import under the benchmark's
    folder ``root``."""
    bad = []
    for d, _, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(d, fname)
            rel = os.path.relpath(path, root)
            rule = FORBIDDEN_IN_REFERENCE if rel.startswith(
                "reference" + os.sep) else FORBIDDEN
            bad += [(rel, n) for n in sorted(imports_of(path) & rule)]
    return bad
