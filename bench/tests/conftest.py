"""Tests of the benchmark's harness. Run from the repository's root:

  PYTHONPATH=src python -m pytest bench/tests -q

Tests marked ``cuda`` need the card and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
