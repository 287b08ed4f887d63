"""The import guard: a run may load neither JAX nor the JAX package, and
the plain reference nothing of the port. Names are compared by their
top-level part whole, since ``x265_tpu_torch`` begins with ``x265_tpu``."""
from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "x265_tpu")
PORT = "x265_tpu_torch"
_REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "reference")


def loaded_forbidden(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def reference_imports_port() -> list:
    """Imports in encbench/reference/*.py whose top-level name is the
    port's or a forbidden one, as (file, module)."""
    bad = []
    for f in sorted(os.listdir(_REF_DIR)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(_REF_DIR, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            bad += [(f, n) for n in names
                    if n.split(".")[0] in FORBIDDEN + (PORT,)]
    return bad
