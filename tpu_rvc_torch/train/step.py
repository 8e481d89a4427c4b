"""The GAN train step (port of tpu_rvc/train/step.py:71-255; reference
infer/modules/train/train.py:508-663).

`TrainState` holds the generator, the discriminator, their two AdamW
optimizers and the step count; `TrainState.train_step(batch)` is one step:
  1. one generator forward (a random latent slice), through the modules'
     differentiable branches (`Synthesizer.forward`): no kernel launches;
  2. the discriminator update on (real slice, fake.detach());
  3. the generator update against the *updated* discriminator (the
     reference's ordering), loss = adv + feature matching + 45 L1(mel)
     + KL, through the graph of step 1 (the JAX step runs the forward
     twice on the same draws; one forward is the same function).

Optimizers: AdamW(lr, betas, eps, weight_decay=0.01), as optax.adamw
(decay applied to every parameter, eps outside the root); the learning
rate is lr * lr_decay ** (step // steps_per_epoch), set before each step,
the step optax's schedule sees.  The step's random draws come from
generators seeded with (hp.train.seed, step): the slice, the posterior eps
and the sine source's noise from one a row, keyed on the row's place in
the global batch, the sine source's initial phase from one the batch
shares.  So a resumed run draws what a straight run draws, and a rank of a
data-parallel step draws for its rows what one process draws for them.

Several processes (`group`, one a card, `torch.distributed`): each holds
rows `rank::world` of the global batch and the step computes the global
batch's step, as the JAX step does over a mesh (`tpu_rvc/train/step.py:
10-13`, where XLA inserts the gradient psum):
  - replicated: the gradients are averaged over the group by all-reduces
    of a few flat buffers, so every rank applies the same update;
  - FSDP (`parallel/fsdp.py` `shard_train_state`): FSDP2 all-gathers
    the parameters and reduce-scatters the gradients;
  - the KL is not a per-row mean (`kl_loss` divides by the mask's sum),
    so each rank scales its masked sum by world / (the group's mask sum),
    and the averaged gradient is the global KL's;
  - the grad norms are taken after the reduction (across the shards under
    FSDP), the returned losses are averaged over the group, and
    `rank_loss_disc` and `rank_loss_gen_all` are this rank's own.

Precision: `hp.train.fp16_run` runs the forwards under
`torch.autocast(bfloat16)`; losses, gradients and parameters stay fp32 and
there is no GradScaler (bf16 has fp32's range).  Otherwise the step is
fp32 with TF32 off (`fp32_math`), as the inference entry points are.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from tpu_rvc_torch.core.config import HParams
from tpu_rvc_torch.core.device import (RowGenerators, deterministic_math,
                                       fp32_math, resolve_device)
from tpu_rvc_torch.models.synthesizer import Synthesizer, make_synthesizer
from tpu_rvc_torch.nn.discriminators import MultiPeriodDiscriminator
from tpu_rvc_torch.ops.mel import mel_spectrogram, spec_to_mel
from tpu_rvc_torch.utils.timing import span
from .losses import discriminator_loss, feature_loss, generator_loss, kl_parts

WEIGHT_DECAY = 0.01
BUCKET_ELEMS = 1 << 25      # 128 MB of fp32 gradients a flat all-reduce
LOSS_TERMS = ("loss_disc", "loss_gen_all", "loss_gen", "loss_fm",
              "loss_mel", "loss_kl")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s draws that the batch shares."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))


def row_generators(seed: int, step: int, rows: List[int],
                   device) -> RowGenerators:
    """Step `step`'s generators of the global batch's rows `rows`, and
    its shared one."""
    base = (int(seed) * 1_000_003 + int(step)) * 1_000_033
    return RowGenerators(
        [torch.Generator(device=device).manual_seed(
            (base + 1 + int(r)) % (2 ** 63)) for r in rows],
        step_generator(seed, step, device))


def global_norm(grads, sharded: bool = False) -> torch.Tensor:
    """The gradients' global L2 norm; `sharded`: of DTensor shards, over
    every rank's."""
    if sharded:
        return torch.nn.utils.get_total_norm(grads).full_tensor()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def all_reduce_mean(params, group) -> None:
    """Average the parameters' gradients over `group`: one all-reduce a
    flat buffer of at most BUCKET_ELEMS elements, the gradients left as
    views of the buffers."""
    n = dist.get_world_size(group)
    buckets, size = [[]], 0
    for p in params:
        last = buckets[-1]
        if last and (size + p.numel() > BUCKET_ELEMS
                     or p.grad.dtype != last[0].grad.dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(p)
        size += p.numel()
    for bucket in buckets:
        flat = torch.cat([p.grad.reshape(-1) for p in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for p, g in zip(bucket, flat.split([p.numel() for p in bucket])):
            p.grad = g.view_as(p)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy or tensors -> tensors on `device`; host arrays go through
    pinned memory, so the copy does not wait for the queued step."""
    out = {}
    with span("upload"):
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.device != torch.device(device):
                if torch.device(device).type == "cuda":
                    t = t.pin_memory()
                t = t.to(device, non_blocking=True)
            out[k] = t
    return out


class TrainState:
    """G, D, their optimizers and the step count on one device; with
    `group`, this process's part of a data-parallel step whose ranks start
    from the same weights (made from one seed, or loaded from one file).

    `rows` (offset, stride): local row j of a batch is row j * stride +
    offset of the global batch, (group rank, group size) by default;
    `fsdp`: FSDP2 reduces the gradients (`parallel/fsdp.py`);
    `deterministic` (off by default): each step runs under
    `core/device.py` `deterministic_math`, so two runs from one seed in
    one process take the same steps bit for bit on a card (the CPU's
    steps are so without it).  Off by default: under it cuDNN times its
    algorithms for each new batch shape, 14-40 s in bf16 on an NVIDIA
    H100 80GB HBM3 at 700 W, and the step costs 1.06x the default's
    (`ROADMAP.md` C.1)."""

    def __init__(self, hp: HParams, net_g: Synthesizer,
                 net_d: MultiPeriodDiscriminator, steps_per_epoch: int = 100,
                 group: Optional[dist.ProcessGroup] = None):
        self.hp = hp
        self.group = group
        self.rows = ((dist.get_rank(group), dist.get_world_size(group))
                     if group is not None else (0, 1))
        self.fsdp = False
        self.net_g, self.net_d = net_g.train(), net_d.train()
        self.device = next(net_g.parameters()).device
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.opt_g, self.opt_d = map(self.make_optimizer, (net_g, net_d))
        self.step = 0
        self.deterministic = False

    def make_optimizer(self, net: torch.nn.Module) -> torch.optim.AdamW:
        t = self.hp.train
        return torch.optim.AdamW(net.parameters(), t.learning_rate,
                                 betas=tuple(t.betas), eps=t.eps,
                                 weight_decay=WEIGHT_DECAY)

    def lr(self, step: Optional[int] = None) -> float:
        t = self.hp.train
        s = self.step if step is None else step
        return t.learning_rate * t.lr_decay ** (s // self.steps_per_epoch)

    def _autocast(self):
        if not self.hp.train.fp16_run:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def _update(self, opt, params, loss) -> torch.Tensor:
        if self.fsdp:
            # FSDP2 differentiates its unsharded parameters, which
            # `inputs=` cannot name: every gradient of the loss is taken,
            # and `train_step` drops D's after the G step
            loss.backward()
        else:
            torch.autograd.backward(loss, inputs=params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.group is not None and not self.fsdp:
            with span("all_reduce", self.device):
                all_reduce_mean(params, self.group)
        norm = global_norm([p.grad for p in params], self.fsdp)
        for group in opt.param_groups:
            group["lr"] = self.lr()
        opt.step()
        for p in params:
            p.grad = None
        return norm

    def step_flops(self, batch: Dict) -> float:
        """FLOPs of one `train_step` on `batch` (`utils/roofline.py`), the
        MFU numerator of a step.  The step runs on a copy of this state,
        which does not advance; a state in a process group is refused (the
        copy would share its group)."""
        if self.group is not None:
            raise ValueError("step_flops: the state is in a process group")
        from tpu_rvc_torch.utils.roofline import graph_flops

        return graph_flops(copy.deepcopy(self).train_step, batch)

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        with span("step", root=True), (
                deterministic_math() if self.deterministic
                else contextlib.nullcontext()):
            return self._train_step(batch)

    @fp32_math()
    def _train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One D-then-G step on a batch of the JAX layout (channel-last):
        phone (B, T, D), phone_lengths (B,), pitch (B, T) int, pitchf
        (B, T), spec (B, T, F), spec_lengths (B,), wave (B, T * hop, 1),
        sid (B,); f0-less batches carry no pitch keys.  Optional pins:
        pin_ids_slice (B,) and pin_noise_eps (B, T, inter_channels) fix
        the slice and the posterior draw and zero the sine noise.  Returns
        0-d device tensors (no host wait) and the first item's slice mels
        `mel_org`/`mel_gen` (seg_frames, n_mels)."""
        hp, dev = self.hp, self.device
        t, d = hp.train, hp.data
        b = batch_to_device(batch, dev)
        seg_frames = t.segment_size // d.hop_length
        offset, stride = self.rows
        gen = row_generators(t.seed, self.step,
                             [j * stride + offset
                              for j in range(b["phone"].shape[0])], dev)
        pins = {}
        if "pin_ids_slice" in b:
            pins["ids_slice"] = b["pin_ids_slice"]
        if "pin_noise_eps" in b:
            pins["noise_eps"] = b["pin_noise_eps"]
        if pins:
            pins["deterministic"] = True
        pitch = ((b["pitch"], b["pitchf"]) if self.net_g.use_f0
                 else (None, None))
        g_params = list(self.net_g.parameters())
        d_params = list(self.net_d.parameters())

        with span("g_forward", dev), self._autocast():
            y_hat, ids, _, z_mask, (z, z_p, m_p, logs_p, m_q, logs_q) = \
                self.net_g(b["phone"], b["phone_lengths"], b["spec"],
                           b["spec_lengths"], b["sid"], *pitch,
                           generator=gen, **pins)
        y_hat = y_hat.transpose(1, 2)                         # (B, 1, seg)
        idx = (ids.long()[:, None] * d.hop_length
               + torch.arange(t.segment_size, device=dev))
        wave_slice = torch.gather(b["wave"][..., 0], 1, idx)[:, None]

        with span("d_step", dev):
            with self._autocast():
                y_dr, y_dg, _, _ = self.net_d(wave_slice, y_hat.detach())
            loss_disc = discriminator_loss(y_dr, y_dg)[0]
            grad_norm_d = self._update(self.opt_d, d_params, loss_disc)

        with span("g_step", dev):
            mel = spec_to_mel(b["spec"].float().transpose(1, 2),
                              d.filter_length, d.n_mel_channels,
                              d.sampling_rate, d.mel_fmin, d.mel_fmax)
            fidx = ids.long()[:, None] + torch.arange(seg_frames, device=dev)
            y_mel = torch.gather(mel.transpose(1, 2), 1, fidx[:, :, None]
                                 .expand(-1, -1, mel.shape[1]))  # (B, S, M)
            y_hat_mel = mel_spectrogram(
                y_hat[:, 0].float(), d.filter_length, d.n_mel_channels,
                d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin,
                d.mel_fmax).transpose(1, 2)
            with self._autocast():
                _, y_dg, fmap_r, fmap_g = self.net_d(wave_slice, y_hat)
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * t.c_mel
            kl_sum, mask_sum = kl_parts(z_p, logs_q, m_p, logs_p, z_mask)
            if self.group is not None:
                # the global batch's KL: this rank's sum over the group's
                # mask sum, times the group's size, which the mean of the
                # gradients (and of the losses) divides out again
                mask_sum = mask_sum.detach().clone()
                dist.all_reduce(mask_sum, group=self.group)
                kl_sum = kl_sum * dist.get_world_size(self.group)
            loss_kl = kl_sum / mask_sum * t.c_kl
            loss_fm = feature_loss(fmap_r, fmap_g)
            loss_gen = generator_loss(y_dg)[0]
            loss_gen_all = loss_gen + loss_fm + loss_mel + loss_kl
            grad_norm_g = self._update(self.opt_g, g_params, loss_gen_all)
            if self.fsdp:
                self.opt_d.zero_grad(set_to_none=True)
        self.step += 1
        losses = {"loss_disc": loss_disc, "loss_gen_all": loss_gen_all,
                  "loss_gen": loss_gen, "loss_fm": loss_fm,
                  "loss_mel": loss_mel, "loss_kl": loss_kl}
        if self.group is not None:
            # the global batch's losses, without a host wait, and this
            # rank's own two, in which a fault in one rank's rows shows
            mean = torch.stack([losses[k].detach() for k in LOSS_TERMS])
            dist.all_reduce(mean, group=self.group)
            mean /= dist.get_world_size(self.group)
            losses = {**dict(zip(LOSS_TERMS, mean.unbind())),
                      "rank_loss_disc": loss_disc,
                      "rank_loss_gen_all": loss_gen_all}
        return {k: v.detach() for k, v in {
            **losses, "grad_norm_g": grad_norm_g, "grad_norm_d": grad_norm_d,
            "mel_org": y_mel[0].float(),
            "mel_gen": y_hat_mel[0].float()}.items()}

    def state_dict(self) -> Dict:
        """Everything a resume needs (the native checkpoint)."""
        return {"net_g": self.net_g.state_dict(),
                "net_d": self.net_d.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.net_g.load_state_dict(sd["net_g"])
        self.net_d.load_state_dict(sd["net_d"])
        self.opt_g.load_state_dict(sd["opt_g"])
        self.opt_d.load_state_dict(sd["opt_d"])
        self.step = int(sd["step"])


def create_train_state(hp: HParams, seed: Optional[int] = None,
                       steps_per_epoch: int = 100, use_f0: bool = True,
                       device=None, g_state=None, d_state=None,
                       group: Optional[dist.ProcessGroup] = None
                       ) -> TrainState:
    """G (the training layout: enc_q, weight norm) and D with random
    weights drawn from `seed` (default hp.train.seed), or loaded from the
    given state_dicts, and fresh optimizers, on `device` (default
    "cuda"); `group` as `TrainState`'s."""
    dev = resolve_device(device)
    seed = hp.train.seed if seed is None else seed
    net_g = make_synthesizer(hp, use_f0=use_f0, device=dev, seed=seed,
                             train=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 5)
        net_d = MultiPeriodDiscriminator(hp.version)
    net_d = net_d.to(dev)
    if g_state is not None:
        net_g.load_state_dict(g_state)
    if d_state is not None:
        net_d.load_state_dict(d_state)
    return TrainState(hp, net_g, net_d, steps_per_epoch, group)
