"""Modules a run may not hold: JAX and the JAX package the port was made
from.  Names are compared whole at the top level, so the port
(``isee3_decoder_tpu_torch``) is not the JAX package
(``isee3_decoder_tpu``)."""

from __future__ import annotations

import ast
import pathlib

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "isee3_decoder_tpu"})
PORT = "isee3_decoder_tpu_torch"


def top_level(names) -> set:
    return {n.split(".")[0] for n in names}


def forbidden_loaded(module_names) -> list:
    """The forbidden top-level names among ``module_names``."""
    return sorted(top_level(module_names) & FORBIDDEN)


def imported_names(path: pathlib.Path) -> set:
    """Top-level names a Python file imports, anywhere in it."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return top_level(names)
