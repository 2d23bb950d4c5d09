"""The import check: no file of the benchmark imports JAX or the JAX
package, and the reference and the generators import nothing of the
program.

    python3 portbench/check_imports.py

Compares each imported module's top-level name (the part before the first
dot) whole, since the port's name ``repro_torch`` begins with the JAX
package's ``repro``. Exits 1 and names each offending import, else 0.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parent
NEVER = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference", "gen")        # these import the program neither


def imported(path: Path) -> List[str]:
    """Top-level names of every module ``path`` imports."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


def offences() -> List[str]:
    out = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(BENCH)
        banned = set(NEVER)
        if rel.parts[0] in YARDSTICK:
            banned.add("repro_torch")
        out += [f"{rel}: imports {n}" for n in imported(path) if n in banned]
    return out


if __name__ == "__main__":
    found = offences()
    print("\n".join(found) or "import check: ok")
    sys.exit(1 if found else 0)
