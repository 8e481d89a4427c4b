"""The control on the card: the reference computed in TF32, one step
below the configuration's fp32, in the program's place, must fail the
cell's limit, while the program passes it.  The cell's shapes are cut to
fit a test run (two files, 8 slots, 8 rows); the benchmark's runs do not run
this.  Run with `python -m pytest rvcbench/tests -q -m cuda` on a card."""

import pytest
import torch

from rvcbench import run
from rvcbench.lib import cells


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["v2-48k.offline", "v2-40k.serve-n32",
                                  "v2-40k.train-b32"])
def test_the_control_fails_the_limit(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = dict(cells.traffic(name))
    if cell["entry"] == "offline":
        cell.update(classes_s=[5, 12], files_per_class=1)
    elif cell["entry"] == "serve":
        cell.update(slots=8, client_s=[2, 3])
    else:
        cell.update(batch_size=8, recordings=2)
    drv = cells.driver(cell["entry"]).Driver(
        cell, cells.config(cell["config"]), 2 ** 31 + 7, "cuda",
        str(tmp_path))
    drv.setup()
    rec = drv.window(3.0, None)
    assert run.passed(drv.check(rec))
    assert not run.passed(drv.control(rec))
