"""The servebench tests run from the repository's root:
``python -m pytest -q servebench/tests``.  They import the program
(``src/``) and the benchmark; none imports JAX."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
