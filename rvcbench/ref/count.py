"""The yardstick's FLOP count: the products (`FlopCounterMode`: matmuls
and convolutions, 2 per multiply-add) of the reference's graph at a
call's shapes, run on the meta device, so nothing is computed.  The
count says what work a call needs, whatever the program does to do it."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import models
from .offline import Offline
from .rmvpe import E2E
from .stream import Geometry, Stream


def _nets(config: Sequence, version: str, use_f0: bool, hubert_kw: Dict,
          index_rows: int):
    with torch.device("meta"):
        hub = models.Hubert(**hubert_kw).eval()
        syn = models.synthesizer_from_config(config, version, use_f0).eval()
        rmv = E2E().eval()
        dim = 256 if version == "v1" else 768
        index = (torch.empty((index_rows, dim)), torch.empty(index_rows))
    return hub, syn, rmv, index


def counted(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kw)
    return int(mode.get_total_flops())


def offline_flops(config: Sequence, version: str, hubert_kw: Dict,
                  bucket_samples: int, index_rows: int,
                  f0_net: bool = True, x_pad: float = 3.0) -> int:
    """One single-chunk conversion whose padded input fills a bucket of
    `bucket_samples` at 16 kHz (`offline.Offline.rows`); `f0_net=False`
    counts a path whose f0 has no products (pm)."""
    hub, syn, rmv, index = _nets(config, version, True, hubert_kw,
                                 index_rows)
    off = Offline(hub, syn, rmv, index, "meta", x_pad=x_pad)
    return counted(off.rows, torch.zeros((1, bucket_samples), device="meta"),
                   use_f0_net=f0_net)


def tick_flops(config: Sequence, version: str, hubert_kw: Dict,
               geo: Geometry, n_streams: int, index_rows: int) -> int:
    """One serving tick over `n_streams` streams (`stream.Stream.block`)."""
    hub, syn, rmv, index = _nets(config, version, True, hubert_kw,
                                 index_rows)
    st = Stream(hub, syn, rmv, index, "meta", geo)
    seg = torch.zeros((n_streams, geo.block_frame + 2 * geo.zc),
                      device="meta")
    return counted(st.block, st.init_state(n_streams), seg, None)


def train_step_flops(cfg: Dict, config: Sequence, batch: int,
                     frames: int) -> int:
    """One training step (`train.Trainer.train_step`: forwards, backwards;
    the optimizers have no products) at `batch` rows of `frames` frames."""
    from .train import Trainer

    d = cfg["data"]
    with torch.device("meta"):
        tr = Trainer(cfg, config, None, None, "meta", 1, dtype=None)
        F = d["filter_length"] // 2 + 1
        b = {"phone": torch.zeros((batch, frames, 768)),
             "phone_lengths": torch.full((batch,), frames),
             "spec": torch.zeros((batch, frames, F)),
             "spec_lengths": torch.full((batch,), frames),
             "wave": torch.zeros((batch, frames * d["hop_length"], 1)),
             "sid": torch.zeros((batch,), dtype=torch.long),
             "pitch": torch.ones((batch, frames), dtype=torch.long),
             "pitchf": torch.ones((batch, frames))}
    tr.opt_g.step = tr.opt_d.step = lambda: None
    return counted(tr.train_step, b, generators=False)
