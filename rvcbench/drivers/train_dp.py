"""The data-parallel training step: `TrainState.train_step` replicated over
a process group, one process a card (NCCL; gloo on the CPU), each rank
fed its rows `rank::world` of every global batch by the port's
`BucketBatcher.epoch_local_slice`, at `batch_size` rows a card.

Rank 0 runs in the harness's process and times the window; the other
ranks run in processes it spawns, which follow its commands over a gloo
group beside the step's: set-up, the window's steps (rank 0 says, a
step ahead, whether another is taken), the release, the check and the
control.  Rank 0 writes the training set and the seed's weights before it
spawns them, and every rank loads those.  The group's rendezvous and
every wait for a rank are bounded (`JOIN_TIMEOUT_S`), so a run that
cannot form the group fails within two minutes rather than hang.

`correct` holds the global batch's step to the reference's, as the
one-card training cell does (`drivers/train.py`): the first step's
losses (the group's means the program returns and each rank's own,
against the mean of the reference's slices and each slice's own), its
first gradient of every leaf (rank 0's,
averaged over the group, against the mean of the reference's slice
gradients), each leaf's change after three steps, and a window step drawn
from the seed, re-run from the state before it; the reference
(`ref/train_dp.py`) runs on every rank's card over its own slice.  And
`replica_gap`: the largest difference of any parameter between rank 0
and another rank after the window, which replicas keep at nought."""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import sys
import threading
import time
import traceback
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from rvcbench.drivers import train as single
from rvcbench.drivers.common import Clock, nothing, phase, sync
from rvcbench.lib import trainset
from rvcbench.lib.inputs import small_model_config, subseeds
from rvcbench.ref.precision import fp8_products
from rvcbench.ref.train import first_grads
from rvcbench.ref.train_data import Batches
from rvcbench.ref.train_dp import SliceTrainer

WINDOW, RELEASE, CHECK, CONTROL, QUIT = range(1, 6)
STOP, STEP = 0, 1
# the group's rendezvous and its collectives wait for a rank this long
JOIN_TIMEOUT_S = 90
# rank 0's phases that hold no collective (the trace's reading, the
# harness's own work) may keep the others waiting for a command this long
COMMAND_TIMEOUT_S = 900


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Rank(single.Driver):
    """One process's part: its card, the groups, its training state."""

    def __init__(self, cell: Dict, cfg: Dict, seed: int, device_type: str,
                 tmp: str, rank: int, world: int, port: int):
        device = (torch.device("cuda", rank) if device_type == "cuda"
                  else torch.device("cpu"))
        super().__init__(cell, cfg, seed, device, tmp)
        self.rank, self.world, self.port = rank, world, port
        self.global_batch = self.batch_size * world
        self.weights_path = os.path.join(tmp, "weights.pt")
        self.filelist = os.path.join(tmp, "exp", "filelist.txt")

    # ---------------------------------------------------------------
    def join(self) -> None:
        timeout = datetime.timedelta(seconds=JOIN_TIMEOUT_S)
        kw = {}
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            kw["device_id"] = self.device
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{self.port}", rank=self.rank,
            world_size=self.world, timeout=timeout, **kw)
        self.group = dist.group.WORLD
        self.ctl = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=COMMAND_TIMEOUT_S))

    def post(self, value: int = 0):
        """Rank 0's `value` on its way to every rank."""
        t = torch.tensor([value], dtype=torch.int64)
        return t, dist.broadcast(t, 0, group=self.ctl, async_op=True)

    @staticmethod
    def arrived(posted) -> int:
        t, work = posted
        work.wait()
        return int(t)

    def flag(self, value: int = 0) -> int:
        """Rank 0's `value`, on every rank."""
        return self.arrived(self.post(value))

    def rank_losses(self, out: Dict) -> List[float]:
        """Every rank's own two losses of a step, in rank order."""
        mine = torch.stack([out["rank_loss_disc"],
                            out["rank_loss_gen_all"]]).float().cpu()
        every = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(every, mine, group=self.ctl)
        return [float(x) for t in every for x in t]

    def setup_state(self) -> None:
        """The seed's weights and the training set as rank 0 wrote them,
        the training state in the group, and the first epoch, which holds
        every bucket shape of the window: its first three steps are the
        ones `correct` judges from the seed."""
        from tpu_rvc_torch.train.data import BucketBatcher, RVCDataset
        from tpu_rvc_torch.train.step import create_train_state

        cfg = self.cfg
        saved = torch.load(self.weights_path, map_location=self.device,
                           weights_only=True)
        self.g0, self.d0 = saved["g"], saved["d"]
        self.plan = Batches(self.filelist, cfg["data"]["hop_length"],
                            self.global_batch, self.batch_seed)
        self.steps_per_epoch = len(self.plan.plan(0))
        hp = single.program_hparams(cfg)
        self.state = create_train_state(
            hp, steps_per_epoch=self.steps_per_epoch, use_f0=bool(cfg["f0"]),
            device=self.device, g_state=self.g0, d_state=self.d0,
            group=self.group)
        self.batcher = BucketBatcher(RVCDataset(self.filelist, hp, True),
                                     self.global_batch, seed=self.batch_seed)
        st = self.state
        g_params = list(st.net_g.parameters())
        d_params = list(st.net_d.parameters())
        self.first = {}
        for i, batch in enumerate(self.batcher.epoch_local_slice(
                0, self.rank, self.world)):
            out = st.train_step(batch)
            if i == 0:
                ranks = self.rank_losses(out)
            if i == 0 and self.rank == 0:
                self.first["losses"] = [float(out["loss_disc"]),
                                        float(out["loss_gen_all"])] + ranks
                self.first["grad1"] = (
                    single.leaf_norms(first_grads(st.opt_g, g_params)) +
                    single.leaf_norms(first_grads(st.opt_d, d_params)))
            if i == single.CHECKED_STEPS - 1 and self.rank == 0:
                self.first["change3"] = self._changes(st.net_g, st.net_d)
        sync(self.device)
        self.epoch = 1
        self.checked_step = self.steps_per_epoch + int(
            np.random.default_rng(subseeds(self.seed, 12)[11]).integers(
                self.steps_per_epoch))

    def _batches(self):
        while True:
            yield from self.batcher.epoch_local_slice(self.epoch, self.rank,
                                                      self.world)
            self.epoch += 1

    def replica_gap(self) -> float:
        """The largest |parameter - rank 0's| over every rank."""
        flat = torch.cat([p.detach().reshape(-1).float()
                          for net in (self.state.net_g, self.state.net_d)
                          for p in net.parameters()])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=self.group)
        gap = (flat - ref).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX, group=self.group)
        return float(gap)

    def release_state(self) -> None:
        del self.state, self.batcher
        self.state = self.batcher = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------
    def _slice(self, bucket: int, rows: List[int]) -> Dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in
                self.plan.batch(bucket, rows[self.rank::self.world]).items()}

    def reference(self, fp8: bool = False) -> Dict:
        """The first three global steps from the seed's weights, each rank
        on its slice of the batches worked out again from the files."""
        cfg = self.cfg
        ref = SliceTrainer(cfg, small_model_config(cfg), self.g0, self.d0,
                           self.device, self.steps_per_epoch, self.group)
        g_params = list(ref.net_g.parameters())
        d_params = list(ref.net_d.parameters())
        got = {}
        plan = self.plan.plan(0)
        with (fp8_products() if fp8 else nothing()):
            for i in range(single.CHECKED_STEPS):
                out = ref.train_step(self._slice(*plan[i]))
                if i == 0:
                    got["losses"] = [float(out["loss_disc"]),
                                     float(out["loss_gen_all"])
                                     ] + self.rank_losses(out)
                    got["grad1"] = (
                        single.leaf_norms(first_grads(ref.opt_g, g_params)) +
                        single.leaf_norms(first_grads(ref.opt_d, d_params)))
        got["change3"] = self._changes(ref.net_g, ref.net_d)
        return got

    def reference_step(self, fp8: bool = False) -> Dict:
        """The checked step again, from the state kept before it."""
        snap = self.judged
        ref = SliceTrainer(self.cfg, small_model_config(self.cfg), snap["g"],
                           snap["d"], self.device, self.steps_per_epoch,
                           self.group)
        ref.step = snap["step"]
        for key, net, opt in self._nets(ref):
            for n, p in net.named_parameters():
                opt.state[p] = {k: v.clone()
                                for k, v in snap[key + "_opt"][n].items()}
        epoch, k = divmod(snap["step"], self.steps_per_epoch)
        with (fp8_products() if fp8 else nothing()):
            out = ref.train_step(self._slice(*self.plan.plan(epoch)[k]))
        return {"losses": (out["loss_disc"], out["loss_gen_all"]),
                "after": self._after(self._nets(ref))}

    def references(self, fp8: bool):
        return self.reference(fp8), self._judged(self.reference_step(fp8))

    # ---------------------------------------------------------------
    def follow(self) -> None:
        """A spawned rank: rank 0's commands until it says to quit."""
        while True:
            cmd = self.flag()
            if cmd == WINDOW:
                self.steps(None, None)
            elif cmd == RELEASE:
                self.release_state()
            elif cmd == CHECK:
                self.references(False)
            elif cmd == CONTROL:
                self.references(True)
                self.references(False)
            elif cmd == QUIT:
                return

    def steps(self, seconds, tracer) -> Dict:
        """The window's steps (rank 0 decides and times them; the others
        take a step each time it says so), the steps a window too short
        for the checked step takes after it, and the replicas' gap.  In
        the window rank 0 sends whether step n + 1 is taken as step n
        starts, and every rank reads it after step n, so no host waits
        for rank 0's between steps."""
        lead = self.rank == 0
        traced = tracer is not None
        it = self._batches()
        waits, shapes, n = [], {}, 0
        self.judged = None
        if traced:
            from tpu_rvc_torch.utils import timing
            timing.enable()
        with (tracer if traced else nothing()):
            start = time.perf_counter()
            ahead = self.post(STEP)
            while self.arrived(ahead) == STEP:
                ahead = self.post(STEP if lead and time.perf_counter() - start
                                  < seconds else STOP)
                t0 = time.perf_counter()
                with phase(traced, "rvcbench.next_batch"):
                    batch = next(it)
                waits.append(time.perf_counter() - t0)
                with phase(traced, "rvcbench.train_step"):
                    out = self._step(batch, self.steps_per_epoch + n)
                n += 1
                frames = int(batch["phone"].shape[1])
                shapes[frames] = shapes.get(frames, 0) + 1
            sync(self.device)
            end = time.perf_counter()
        spans = {}
        if traced:
            spans = timing.read()
            timing.disable()
        steps = n
        k = self.steps_per_epoch + n
        while self.flag(STEP if lead and k <= self.checked_step
                        else STOP) == STEP:
            out = self._step(next(it), k)
            k += 1
        gap = self.replica_gap()
        finite = steps > 0 and all(bool(torch.isfinite(out[key])) for key
                                   in ("loss_disc", "loss_gen_all"))
        return {"window_s": end - start, "attempted": steps,
                "failed": 0 if finite else 1, "errors": [], "steps": steps,
                "batch_wait_s": waits, "shapes": shapes, "spans": spans,
                "replica_gap": gap}


def _watch(parent: int) -> None:
    """End this rank if rank 0's process is gone."""
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(3)


def _worker(cell, cfg, seed, device_type, tmp, rank, world, port,
            parent) -> None:
    os.dup2(2, 1)   # rank 0's standard output carries the result alone
    threading.Thread(target=_watch, args=(parent,), daemon=True).start()
    try:
        torch.set_num_threads(1)
        r = Rank(cell, cfg, seed, device_type, tmp, rank, world, port)
        r.join()
        r.setup_state()
        r.follow()
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Driver(Rank):
    """Rank 0, as the harness drives it.  A process holds one group at a
    time, so a driver's set-up closes the one before it, if any (several
    seeds in one process, as `calibrate.py` runs them)."""

    live = None

    def __init__(self, cell: Dict, cfg: Dict, seed: int, device, tmp: str):
        super().__init__(cell, cfg, seed, torch.device(device).type, tmp, 0,
                         int(cell["chips"]), free_port())
        self.procs, self.idle = [], False

    def command(self, cmd: int) -> None:
        self.idle = False
        self.flag(cmd)

    def setup(self) -> None:
        cfg, clock = self.cfg, Clock()
        g0, d0 = trainset.weights_for_training(cfg, self.seed, self.device)
        torch.save({"g": g0, "d": d0}, self.weights_path)
        del g0, d0
        clock.lap("weights")
        trainset.write(os.path.dirname(self.filelist), cfg, self.cell,
                       self.seed, self.device)
        clock.lap("inputs")
        if Driver.live is not None:
            Driver.live.close()
        Driver.live = self
        ctx = torch.multiprocessing.get_context("spawn")
        for r in range(1, self.world):
            p = ctx.Process(target=_worker, daemon=True, args=(
                self.cell, cfg, self.seed, self.device.type, self.tmp, r,
                self.world, self.port, os.getpid()))
            p.start()
            self.procs.append(p)
        atexit.register(self.close)
        self.join()
        clock.lap("join")
        self.setup_state()
        self.idle = True
        clock.lap("warm")
        self.setup_laps = clock.laps

    def window(self, seconds: float, tracer) -> Dict:
        self.command(WINDOW)
        rec = self.steps(seconds, tracer)
        self.idle = True
        return rec

    def release(self) -> None:
        self.command(RELEASE)
        self.release_state()
        self.idle = True

    def check(self, rec: Dict) -> List[Dict]:
        self.command(CHECK)
        want, want_w = self.references(False)
        self.idle = True
        limits = self.cell["check"]
        return single.compare(self.first, want, limits,
                              self._judged(self.judged), want_w) + [
            {"name": "replica_gap", "value": rec["replica_gap"],
             "limit": limits["replica_gap"]}]

    def control(self, rec: Dict) -> List[Dict]:
        """The same comparison with the reference in fp8 in the program's
        place."""
        self.command(CONTROL)
        got, got_w = self.references(True)
        want, want_w = self.references(False)
        self.idle = True
        return single.compare(got, want, self.cell["check"], got_w, want_w)

    def count(self, rec: Dict) -> Dict:
        """The yardstick's FLOPs of the window's global steps."""
        from rvcbench.ref.count import train_step_flops

        cfg = self.cfg
        flops = sum(n * train_step_flops(cfg, small_model_config(cfg),
                                         self.global_batch, frames)
                    for frames, n in rec["shapes"].items())
        return {"flops": flops}

    def close(self) -> None:
        """Quit the other ranks (at the latest when the process exits),
        then leave the group; once, and only for the driver whose group
        is up."""
        if Driver.live is not self:
            return
        Driver.live = None
        if dist.is_initialized() and self.idle:
            self.command(QUIT)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        self.procs = []
        if dist.is_initialized():
            dist.destroy_process_group()
