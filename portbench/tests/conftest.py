"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the repository's root. They import the port from ``src`` and the
benchmark as the package ``portbench``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
