"""Training orchestration (port of tpu_rvc/train/loop.py:101-273;
reference infer/modules/train/train.py:132-737).

`run_training` drives: filelist -> dataset -> bucketed batches -> the GAN
step (`train/step.py`) -> per-epoch checkpoints -> the final small model.
Checkpoints:
  state_{epoch}.pt  the native checkpoint, `torch.save` of G, D, both
                    optimizers, the step and the epoch; loaded back key by
                    key and shape by shape (`load_native_checkpoint` raises
                    on any mismatch), and the latest one resumes a run at
                    its epoch (the JAX loop derives the epoch from the
                    step, which is wrong once an epoch has more batches
                    than steps_per_epoch);
  G_{epoch}.pth     the generator in the reference layout (weight norm
                    kept, enc_q included), as the reference trainer writes
                    it (infer/lib/train/utils.py:89-107);
  {name}.pth        the small model (`ckpt/small_model.py`).
Several processes, one a card (`parallel/multihost.py` `initialize`
first): every process runs the same call; the global batch is rounded to
a multiple of the process count, each process feeds its rows of every
global batch (`BucketBatcher.epoch_local_slice`) to a step that averages
over the group (`train/step.py`), and only the primary process writes the
filelist, the checkpoints, the small model and tensorboard.  Every rank's
weights are the same, so rank 0 writes what a one-process run writes.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_rvc_torch.core.config import HParams
from tpu_rvc_torch.core.device import resolve_device
from tpu_rvc_torch.parallel import multihost as mh
from .data import BucketBatcher, RVCDataset, write_filelist
from .step import TrainState, create_train_state

logger = logging.getLogger(__name__)
SR_TAGS = {32000: "32k", 40000: "40k", 48000: "48k"}


def save_native_checkpoint(path: str, state: TrainState,
                           epoch: int) -> None:
    torch.save({"state": state.state_dict(), "epoch": int(epoch)}, path)


def _check_same(path: str, what: str, got: Dict, want: Dict) -> None:
    if list(got) != list(want):
        missing = [k for k in want if k not in got]
        extra = [k for k in got if k not in want]
        raise ValueError(f"{path}: {what} keys differ (missing "
                         f"{missing[:4]}, unexpected {extra[:4]}): wrong "
                         "model or optimizer config?")
    for k, v in want.items():
        g = got[k]
        if torch.is_tensor(v) and tuple(g.shape) != tuple(v.shape):
            raise ValueError(f"{path}: {what} {k} shape {tuple(g.shape)} != "
                             f"expected {tuple(v.shape)}")


def load_native_checkpoint(path: str, state: TrainState) -> int:
    """Load a native checkpoint into `state`, validated against it first:
    every model key and shape, every optimizer moment's shape; returns the
    epoch it was written after.  A truncated or config-mismatched file
    raises instead of loading a wrong state (tpu_rvc/train/loop.py:41-63)."""
    # to the host first: `Optimizer.load_state_dict` moves the moments to
    # their parameters' device and keeps each `step` count where it finds
    # it, and a count on the card costs AdamW a device sync per parameter
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd, want = ckpt["state"], state.state_dict()
    _check_same(path, "checkpoint", sd, want)
    for net in ("net_g", "net_d"):
        _check_same(path, net, sd[net], want[net])
    for opt, net in (("opt_g", "net_g"), ("opt_d", "net_d")):
        params = list(getattr(state, net).parameters())
        got = sd[opt]["state"]
        if len(sd[opt]["param_groups"][0]["params"]) != len(params):
            raise ValueError(f"{path}: {opt} holds "
                             f"{len(sd[opt]['param_groups'][0]['params'])} "
                             f"parameters, the model {len(params)}")
        for i, moments in got.items():
            for m in ("exp_avg", "exp_avg_sq"):
                if tuple(moments[m].shape) != tuple(params[int(i)].shape):
                    raise ValueError(f"{path}: {opt} state {i} {m} shape "
                                     f"{tuple(moments[m].shape)} != "
                                     f"{tuple(params[int(i)].shape)}")
    state.load_state_dict(sd)
    return int(ckpt["epoch"])


def latest_checkpoint(dirpath: str, prefix: str = "state_") -> Optional[str]:
    paths = glob.glob(os.path.join(dirpath, f"{prefix}*.pt"))
    if not paths:
        return None
    return max(paths, key=lambda p: int(
        "".join(filter(str.isdigit, os.path.basename(p))) or 0))


def export_reference_g_pth(path: str, net_g: torch.nn.Module, epoch: int,
                           lr: float) -> None:
    """G_{epoch}.pth: weights in the reference layout and metadata; the
    optimizer stays in the native checkpoint."""
    sd = {k: v.detach().cpu() for k, v in net_g.state_dict().items()}
    torch.save({"model": sd, "iteration": epoch, "learning_rate": lr,
                "optimizer": None}, path)


def mel_image(mel: np.ndarray) -> np.ndarray:
    """(T, M) mel -> (3, M, T) image in [0, 1] for tensorboard (role of the
    reference's plot_spectrogram_to_numpy, without matplotlib)."""
    m = np.asarray(mel, np.float32).T[::-1]
    lo, hi = float(m.min()), float(m.max())
    m = (m - lo) / (hi - lo + 1e-8)
    return np.stack([m, m, 1.0 - m])


def _summary_writer(logdir: str):
    """tensorboardX or torch's writer, whichever is installed, else None."""
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return __import__(mod, fromlist=["SummaryWriter"]).SummaryWriter(
                logdir)
        except Exception:
            continue
    return None


def warm_start(state: TrainState, pretrain_g: str, pretrain_d: str,
               log) -> None:
    """Shape-checked partial load of reference pretrained G/D
    (tpu_rvc/train/loop.py:162-189,275-290)."""
    from tpu_rvc_torch.ckpt.convert import (merge_partial,
                                            train_state_from_reference)
    for path, net, what in ((pretrain_g, state.net_g, "G"),
                            (pretrain_d, state.net_d, "D")):
        if not path or not os.path.exists(path):
            continue
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt.get("weight", ckpt))
        n = merge_partial(net, train_state_from_reference(sd))
        log(f"partial load: {n}/{len(net.state_dict())} tensors matched; "
            f"loaded pretrained {what} from {path}")


def run_training(exp_dir: str, hp: HParams, *, total_epochs: int = 10,
                 if_f0: bool = True, save_every_epoch: int = 5,
                 pretrain_g: str = "", pretrain_d: str = "",
                 name: str = "model", author: str = "",
                 cache_in_hbm: bool = False, log_fn=None,
                 tensorboard: bool = True, device=None) -> Dict[str, Any]:
    """Fine-tune on a prepared experiment dir on `device` (default the
    card: this process's card once the job is joined); returns the last
    step's scalar metrics, the global batch's.

    cache_in_hbm: after the first epoch every batch (this process's rows)
    stays on the device and only the batch order reshuffles per epoch
    (reference if_cache_data_in_gpu, train.py:425-501, which also freezes
    batch composition once cached)."""
    device = resolve_device(device)
    log = log_fn or (lambda s: logger.info(s))
    world, rank = mh.process_count(), mh.process_index()
    primary = mh.is_primary()
    tb = (_summary_writer(os.path.join(exp_dir, "tb"))
          if tensorboard and primary else None)
    sr_tag = SR_TAGS[hp.data.sampling_rate]
    filelist = os.path.join(exp_dir, "filelist.txt")
    if primary and not os.path.exists(filelist):
        write_filelist(exp_dir, hp.version, if_f0, 0, sr_tag)
    if world > 1:
        dist.barrier()      # the others read the filelist rank 0 wrote
    ds = RVCDataset(filelist, hp, if_f0=if_f0)
    bs = max(hp.train.batch_size // world * world, world)
    batcher = BucketBatcher(ds, bs, seed=hp.train.seed)
    steps_per_epoch = max(len(ds) // bs, 1)
    state = create_train_state(hp, steps_per_epoch=steps_per_epoch,
                               use_f0=bool(if_f0), device=device,
                               group=mh.data_group())

    ckpt = latest_checkpoint(exp_dir)
    start_epoch = 0
    if ckpt:
        start_epoch = load_native_checkpoint(ckpt, state)
        log(f"resumed from {ckpt} at epoch {start_epoch}")
    else:
        warm_start(state, pretrain_g, pretrain_d, log)
    if world > 1:
        # only rank 0 writes checkpoints: every process must resume from
        # the same one (the experiment dir on shared storage)
        start_epoch = mh.assert_same_across_hosts(start_epoch,
                                                  "resume start_epoch")

    metrics: Dict[str, torch.Tensor] = {}
    cache = [] if cache_in_hbm else None
    cache_ready = False
    for epoch in range(start_epoch, total_epochs):
        t0 = time.time()
        n_batches = 0
        if cache_ready:
            order = np.random.default_rng(
                hp.train.seed + epoch).permutation(len(cache))
            batches = (cache[i] for i in order)
        elif world > 1:
            batches = batcher.epoch_local_slice(epoch, rank, world)
        else:
            batches = batcher.epoch(epoch)
        for batch in batches:
            if cache is not None and not cache_ready:
                batch = mh.global_batch_from_local(batch, state.device)
                cache.append(batch)
            metrics = state.train_step(batch)
            n_batches += 1
            mel_org, mel_gen = metrics.pop("mel_org"), metrics.pop("mel_gen")
            if tb is not None and state.step % hp.train.log_interval == 0:
                for k, v in metrics.items():
                    tb.add_scalar(f"train/{k}", float(v), state.step)
                tb.add_scalar("train/lr", state.lr(state.step), state.step)
                tb.add_image("slice/mel_org", mel_image(mel_org.cpu()),
                             state.step)
                tb.add_image("slice/mel_gen", mel_image(mel_gen.cpu()),
                             state.step)
        if cache is not None and not cache_ready and cache:
            cache_ready = True
            log(f"cached {len(cache)} batches on {state.device} (batch "
                "composition frozen, order reshuffles per epoch)")
        log(f"epoch {epoch + 1}/{total_epochs}: {n_batches} steps in "
            f"{time.time() - t0:.1f}s, "
            + ", ".join(f"{k}={float(v):.3f}" for k, v in metrics.items()))
        if primary and ((epoch + 1) % save_every_epoch == 0
                        or epoch + 1 == total_epochs):
            save_native_checkpoint(
                os.path.join(exp_dir, f"state_{epoch + 1}.pt"), state,
                epoch + 1)
            export_reference_g_pth(
                os.path.join(exp_dir, f"G_{epoch + 1}.pth"), state.net_g,
                epoch + 1, state.lr((epoch + 1) * steps_per_epoch))

    if not primary:
        return {k: float(v) for k, v in metrics.items()}
    from tpu_rvc_torch.ckpt.small_model import save_small_model
    out = save_small_model(state.net_g.state_dict(), sr_tag, int(if_f0),
                           name, total_epochs, hp.version, hp,
                           out_path=os.path.join(exp_dir, f"{name}.pth"),
                           author=author)
    log(f"saved small model to {out}")
    if tb is not None:
        tb.close()
    return {k: float(v) for k, v in metrics.items()}
