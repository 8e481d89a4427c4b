"""The training step through `TrainState.train_step`, fed by the port's
`BucketBatcher` over a training set written in set-up from the seed, at
the cell's batch size, with the default (non-deterministic) settings.

Set-up builds the one training state from the seed's weights and drives
it through the first epoch, which holds every bucket shape the window
feeds: its first three steps are the ones `correct` judges from the seed
(their losses, the first gradient of every leaf as the optimizer's first
moment holds it, each leaf's change after the three).  The window goes on
with the same state, epoch after epoch, until `--seconds` have passed; it
ends when the card has finished the last step it was given.  One step of
the window's first epoch, drawn from the seed, is judged too: the state
before it is kept, and the reference takes that step again from it, on
the batch it works out from the files for that epoch and step, at the
rate the schedule gives there."""

from __future__ import annotations

import os
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from rvcbench.drivers.common import Clock, nothing, phase, sync
from rvcbench.lib import trainset
from rvcbench.lib.inputs import small_model_config, subseeds
from rvcbench.ref.precision import fp8_products
from rvcbench.ref.train import Trainer, first_grads
from rvcbench.ref.train_data import Batches

CHECKED_STEPS = 3


def program_hparams(cfg: Dict):
    """The configuration as the port's HParams."""
    from tpu_rvc_torch.core.config import (DataConfig, HParams, ModelConfig,
                                           TrainConfig)

    t, d, m = dict(cfg["train"]), dict(cfg["data"]), dict(cfg["model"])
    t["betas"] = tuple(t["betas"])
    for k in ("resblock_kernel_sizes", "upsample_rates",
              "upsample_kernel_sizes"):
        m[k] = tuple(m[k])
    m["resblock_dilation_sizes"] = tuple(tuple(x) for x in
                                         m["resblock_dilation_sizes"])
    return HParams(version=cfg["version"], train=TrainConfig(**t),
                   data=DataConfig(**d), model=ModelConfig(**m))


def first_moment(opt, p) -> torch.Tensor:
    """AdamW's first moment of `p` (nought before its first step)."""
    m = opt.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m


def leaf_norms(tensors) -> List[float]:
    return [float(x) for x in torch.stack(
        torch._foreach_norm([t.float() for t in tensors])).cpu()]


class Driver:
    def __init__(self, cell: Dict, cfg: Dict, seed: int, device, tmp: str):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.device = torch.device(device)
        self.tmp = tmp
        self.batch_size = int(cell["batch_size"])
        self.batch_seed = int(subseeds(seed, 11)[10] % 2 ** 31)

    def setup(self) -> None:
        from tpu_rvc_torch.train.data import BucketBatcher, RVCDataset
        from tpu_rvc_torch.train.step import create_train_state

        cfg, clock = self.cfg, Clock()
        self.g0, self.d0 = trainset.weights_for_training(cfg, self.seed,
                                                         self.device)
        clock.lap("weights")
        self.filelist = trainset.write(os.path.join(self.tmp, "exp"), cfg,
                                       self.cell, self.seed, self.device)
        clock.lap("inputs")
        self.plan = Batches(self.filelist, cfg["data"]["hop_length"],
                            self.batch_size, self.batch_seed)
        self.steps_per_epoch = len(self.plan.plan(0))
        hp = program_hparams(cfg)
        self.state = create_train_state(
            hp, steps_per_epoch=self.steps_per_epoch, use_f0=bool(cfg["f0"]),
            device=self.device, g_state=self.g0, d_state=self.d0)
        self.batcher = BucketBatcher(RVCDataset(self.filelist, hp, True),
                                     self.batch_size, seed=self.batch_seed)
        clock.lap("load")
        st = self.state
        g_params = list(st.net_g.parameters())
        d_params = list(st.net_d.parameters())
        self.first = {}
        for i, batch in enumerate(self.batcher.epoch(0)):
            out = st.train_step(batch)
            if i == 0:
                self.first["losses"] = [float(out["loss_disc"]),
                                        float(out["loss_gen_all"])]
                self.first["grad1"] = (
                    leaf_norms(first_grads(st.opt_g, g_params)) +
                    leaf_norms(first_grads(st.opt_d, d_params)))
            if i == CHECKED_STEPS - 1:
                self.first["change3"] = self._changes(st.net_g, st.net_d)
        sync(self.device)
        clock.lap("warm")
        self.epoch = 1
        self.checked_step = self.steps_per_epoch + int(
            np.random.default_rng(subseeds(self.seed, 12)[11]).integers(
                self.steps_per_epoch))
        self.setup_laps = clock.laps

    def _changes(self, net_g, net_d) -> List[float]:
        now = ([p for _, p in net_g.named_parameters()] +
               [p for _, p in net_d.named_parameters()])
        was = ([self.g0[n] for n, _ in net_g.named_parameters()] +
               [self.d0[n] for n, _ in net_d.named_parameters()])
        return leaf_norms([a.detach() - b for a, b in zip(now, was)])

    # ---------------------------------------------------------------
    def _batches(self):
        while True:
            yield from self.batcher.epoch(self.epoch)
            self.epoch += 1

    def _nets(self, state):
        return (("g", state.net_g, state.opt_g),
                ("d", state.net_d, state.opt_d))

    def _before(self) -> Dict:
        """The state before the checked step: the weights (as the seed's
        were handed over, by name) and the optimizers' state."""
        snap = {"step": self.checked_step}
        for key, net, opt in self._nets(self.state):
            sd = net.state_dict()
            names = self.g0 if key == "g" else self.d0
            snap[key] = {n: sd[n].detach().clone() for n in names}
            snap[key + "_opt"] = {
                n: {k: v.clone() for k, v in opt.state[p].items()}
                for n, p in net.named_parameters()}
        return snap

    @staticmethod
    def _after(nets) -> Dict:
        """Each leaf's weights and first moment after the step."""
        return {key: {n: (p.detach().clone(), first_moment(opt, p).clone())
                      for n, p in net.named_parameters()}
                for key, net, opt in nets}

    def _step(self, batch, n: int):
        """The window's step `n` (counted from the first of set-up)."""
        if n != self.checked_step:
            return self.state.train_step(batch)
        self.judged = self._before()
        out = self.state.train_step(batch)
        self.judged["after"] = self._after(self._nets(self.state))
        self.judged["losses"] = (out["loss_disc"], out["loss_gen_all"])
        return out

    def window(self, seconds: float, tracer) -> Dict:
        from tpu_rvc_torch.utils import timing

        traced = tracer is not None
        it = self._batches()
        waits, shapes, steps, out = [], {}, 0, None
        self.judged = None
        if traced:
            timing.enable()
        ctx = tracer if traced else nothing()
        with ctx:
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                t0 = time.perf_counter()
                with phase(traced, "rvcbench.next_batch"):
                    batch = next(it)
                waits.append(time.perf_counter() - t0)
                with phase(traced, "rvcbench.train_step"):
                    out = self._step(batch, self.steps_per_epoch + steps)
                steps += 1
                frames = int(batch["phone"].shape[1])
                shapes[frames] = shapes.get(frames, 0) + 1
            sync(self.device)
            end = time.perf_counter()
        spans = timing.read() if traced else {}
        timing.disable()
        # a window too short for the checked step takes it after the close
        n = self.steps_per_epoch + steps
        while n <= self.checked_step:
            self._step(next(it), n)
            n += 1
        finite = out is not None and all(
            bool(torch.isfinite(out[k])) for k in ("loss_disc",
                                                   "loss_gen_all"))
        return {"window_s": end - start, "attempted": steps,
                "failed": 0 if finite else 1, "errors": [],
                "steps": steps, "batch_wait_s": waits, "shapes": shapes,
                "spans": spans}

    def release(self) -> None:
        del self.state, self.batcher
        self.state = self.batcher = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------
    def reference(self, fp8: bool = False) -> Dict:
        """The first three steps again from the seed's weights, on the
        batches worked out again from the files."""
        cfg = self.cfg
        ref = Trainer(cfg, small_model_config(cfg), self.g0, self.d0,
                      self.device, self.steps_per_epoch)
        g_params = list(ref.net_g.parameters())
        d_params = list(ref.net_d.parameters())
        got = {}
        batches = self.plan.epoch(0)
        with (fp8_products() if fp8 else nothing()):
            for i in range(CHECKED_STEPS):
                b = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(batches).items()}
                out = ref.train_step(b)
                if i == 0:
                    got["losses"] = [float(out["loss_disc"]),
                                     float(out["loss_gen_all"])]
                    got["grad1"] = (
                        leaf_norms(first_grads(ref.opt_g, g_params)) +
                        leaf_norms(first_grads(ref.opt_d, d_params)))
        got["change3"] = self._changes(ref.net_g, ref.net_d)
        return got

    def reference_step(self, fp8: bool = False) -> Dict:
        """The checked step again, from the state kept before it."""
        snap = self.judged
        ref = Trainer(self.cfg, small_model_config(self.cfg), snap["g"],
                      snap["d"], self.device, self.steps_per_epoch)
        ref.step = snap["step"]
        for key, net, opt in self._nets(ref):
            for n, p in net.named_parameters():
                opt.state[p] = {k: v.clone()
                                for k, v in snap[key + "_opt"][n].items()}
        epoch, k = divmod(snap["step"], self.steps_per_epoch)
        b = {key: torch.as_tensor(v, device=self.device) for key, v in
             self.plan.batch(*self.plan.plan(epoch)[k]).items()}
        with (fp8_products() if fp8 else nothing()):
            out = ref.train_step(b)
        return {"losses": (out["loss_disc"], out["loss_gen_all"]),
                "after": self._after(self._nets(ref))}

    def _judged(self, step: Dict) -> Dict:
        """A checked step's losses, and each leaf's gradient (from the
        first moment before and after, which AdamW moves by (1 - beta1)
        g) and change, as norms."""
        beta1 = self.cfg["train"]["betas"][0]
        grads, changes = [], []
        for key in ("g", "d"):
            for n, (p, m) in step["after"][key].items():
                m0 = self.judged[key + "_opt"][n].get("exp_avg")
                grads.append((m if m0 is None else m - beta1 * m0)
                             / (1.0 - beta1))
                changes.append(p - self.judged[key][n])
        return {"losses": [float(x) for x in step["losses"]],
                "grad": leaf_norms(grads), "change": leaf_norms(changes)}

    def check(self, rec: Dict) -> List[Dict]:
        return compare(self.first, self.reference(), self.cell["check"],
                       self._judged(self.judged),
                       self._judged(self.reference_step()))

    def control(self, rec: Dict) -> List[Dict]:
        return compare(self.reference(fp8=True), self.reference(),
                       self.cell["check"],
                       self._judged(self.reference_step(fp8=True)),
                       self._judged(self.reference_step()))

    def count(self, rec: Dict) -> Dict:
        """The yardstick's FLOPs of the window's steps, at each batch
        shape the window fed."""
        from rvcbench.ref.count import train_step_flops

        cfg = self.cfg
        flops = sum(n * train_step_flops(cfg, small_model_config(cfg),
                                         self.batch_size, frames)
                    for frames, n in rec["shapes"].items())
        return {"flops": flops}


def _relative(got, want) -> float:
    """The widest of the gaps between paired numbers, over the want's."""
    return max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got, want))


def _leaf_gaps(got: List[float], want: List[float], keep: List[int]
               ) -> List[float]:
    """Each kept leaf's gap of norms over the larger of the reference's
    norm of that leaf and of the median kept leaf."""
    med = statistics.median(want[i] for i in keep)
    return [abs(got[i] - want[i]) / max(want[i], med) for i in keep]


def _kept(grads: List[float]) -> List[int]:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more: the others are nought but rounding, as a key's bias
    under softmax."""
    med = statistics.median(grads)
    return [i for i, w in enumerate(grads) if w >= 1e-3 * med]


def compare(got: Dict, want: Dict, limits: Dict, got_w: Dict,
            want_w: Dict) -> List[Dict]:
    """The first three steps from the seed: the first step's losses
    (`loss_gap`), each leaf's first gradient (`grad1_gap`, the worst
    leaf) and its change after the three steps (`change3_gap`, the median
    leaf).  The checked step of the window, from the state before it: its
    losses (`wloss_gap`), each leaf's gradient (`wgrad_gap`, the worst
    leaf) and change (`wchange_gap`, the median leaf)."""
    keep, w_keep = _kept(want["grad1"]), _kept(want_w["grad"])
    numbers = {
        "loss_gap": _relative(got["losses"], want["losses"]),
        "grad1_gap": max(_leaf_gaps(got["grad1"], want["grad1"], keep)),
        "change3_gap": statistics.median(
            _leaf_gaps(got["change3"], want["change3"], keep)),
        "wloss_gap": _relative(got_w["losses"], want_w["losses"]),
        "wgrad_gap": max(_leaf_gaps(got_w["grad"], want_w["grad"], w_keep)),
        "wchange_gap": statistics.median(
            _leaf_gaps(got_w["change"], want_w["change"], w_keep))}
    if not all(np.isfinite(v) for v in numbers.values()):
        numbers = dict.fromkeys(numbers, float("inf"))
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in numbers.items()] + [
        {"name": "leaves_left_out", "value": len(want["grad1"]) - len(keep),
         "limit": None}]
