"""The yardstick's FLOP count against the counts the port's R1 recorded
(PERF.md, PR 14), and K2's work formula against FlopCounterMode."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from rvcbench.lib import cells
from rvcbench.lib.inputs import small_model_config
from rvcbench.ref import count, models
from rvcbench.ref.modules import ResBlock1
from rvcbench.ref.stream import Geometry


def _v2_48k():
    cfg = cells.config("rvc-v2-48k")
    return small_model_config(cfg), models.hubert_kwargs(cfg["hubert"])


def test_counts_equal_r1_to_the_last_digit():
    """R1: a 10 s file (a 16 s bucket) with a 10k-row index; the v2/48k
    tick of 8 streams of 48 kHz clients."""
    conf, hk = _v2_48k()
    assert count.offline_flops(conf, "v2", hk, 256000, 10000) == \
        2185356752256
    assert count.offline_flops(conf, "v2", hk, 256000, 10000,
                               f0_net=False) == 2068091204736
    geo = Geometry(48000, 0.25, 0.05, 2.5)
    assert count.tick_flops(conf, "v2", hk, geo, 8, 10000) == 639042623024


def test_k2_formula_equals_the_counted_plain_stage():
    k2 = cells.metric("k2_roofline_pct.infer")
    C, T, N, ks = 16, 37, 3, (3, 7, 11)
    blocks = [ResBlock1(C, k, (1, 3, 5)) for k in ks]
    x = torch.zeros((N, C, T))
    with FlopCounterMode(display=False) as mode:
        sum(rb(x) for rb in blocks) / len(blocks)
    assert mode.get_total_flops() == k2.stage_work(C, T, ks, N)
