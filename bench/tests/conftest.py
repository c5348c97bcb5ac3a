"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the repository.  They put the repository and ``src`` on the
path, as ``bench/run.py`` does."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
