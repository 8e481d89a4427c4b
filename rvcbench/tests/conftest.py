"""The benchmark's own tests (not collected by `pytest tests/`): run them
with `python -m pytest rvcbench/tests -q`; those marked `cuda` need a
card and skip without one."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
