"""The separation cell at a tiny size on the CPU, as a run drives it (the
look for a card skipped): the checkpoint in upstream's layout, set-up,
the traced window through the port's `load_separator` and
`DeviceSeparator`, the check against the plain reference, the metrics;
and the yardstick against a count of the net's windows."""

import numpy as np
import torch

from rvcbench import run
from rvcbench.drivers.separate import separation_flops
from rvcbench.lib import cells
from rvcbench.lib.uvr5_weights import first_window, hp5_state
from rvcbench.ref.count import counted
from rvcbench.ref.uvr5 import CascadedASPPNet
from rvcbench.tests.tiny_separate import (OFFSET, WINDOW, tiny_separation,
                                          use_tiny_program)

torch.set_num_threads(4)
NAME = "uvr5-hp5.separate-songs"


def test_a_traced_run_is_correct_and_reads_its_metrics(monkeypatch,
                                                       tmp_path):
    use_tiny_program(monkeypatch, tmp_path)
    cell, cfg = tiny_separation(NAME)
    out = run.run_cell(NAME, 3 * 2 ** 31 + 5, 2.0, True, "cpu",
                       str(tmp_path), cell=cell, cfg=cfg)
    rec = out["rec"]
    print(out["checks"])
    assert run.passed(out["checks"]), out["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["flops"] > 0
    for m in cells.metrics_for(NAME, False) + cells.metrics_for(NAME, True):
        value = cells.metric(m["name"]).read(rec)
        print(m["name"], value)
        assert value is not None and value > 0, m["name"]
    # every window of every finished call, counted by the program
    drv = out["driver"]
    want = sum(-(-(1 + drv.bucket(k["samples"]) // 120)
                 // (WINDOW - 2 * OFFSET))
               for k, o in zip(rec["calls"], rec["outs"]) if o is not None)
    assert rec["spans"]["count.uvr5.windows"] == want
    assert run.forbidden_modules() == []


def test_the_checkpoint_is_upstreams_layout_and_keeps_the_scale():
    """Every key of upstream's CascadedASPPNet, fp32, the BatchNorms'
    statistics from the calibration pass: the mask's logits spread
    without saturating the sigmoid."""
    _, cfg = tiny_separation(NAME)
    sd = hp5_state(cfg, 2 ** 33 + 1, "cpu")
    net = CascadedASPPNet(cfg["modelparams"]["bins"] * 2, cfg["offset"])
    assert list(sd) == list(net.state_dict())
    assert all(v.dtype == torch.float32 for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    net.load_state_dict(sd)
    net.eval()
    x = first_window(net, cfg, 2 ** 33 + 2, "cpu")
    logits = []
    net.out.register_forward_hook(lambda m, i, o: logits.append(o))
    with torch.no_grad():
        net(x)
    z = logits[0]
    print("mask logits: std", float(z.std()), "saturated share",
          float((z.abs() > 6).float().mean()))
    assert 0.2 < float(z.std()) < 3.0
    assert float((z.abs() > 6).float().mean()) < 0.01


def test_the_yardstick_counts_the_windows():
    """A bucket's count is its windows times one window's products, plus
    the resample pyramid's."""
    _, cfg = tiny_separation(NAME)
    with torch.device("meta"):
        net = CascadedASPPNet(cfg["modelparams"]["bins"] * 2, OFFSET)
    window = counted(net.predict, torch.zeros(
        (1, 2, cfg["modelparams"]["bins"] + 1, WINDOW), device="meta"),
        {"value": 0.1, "split_bin": 10})
    one, two = separation_flops(cfg, 6000), separation_flops(cfg, 12000)
    frames = np.array([1 + 6000 // 120, 1 + 12000 // 120])
    wins = -(-frames // (WINDOW - 2 * OFFSET))
    assert one > wins[0] * window and two > wins[1] * window
    assert one - wins[0] * window < 0.5 * window
