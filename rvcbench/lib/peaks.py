"""The card's published peaks (`peaks.json`), the denominators of every
share of a peak or a roofline."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak(name: str) -> float:
    return float(PEAKS[name])
