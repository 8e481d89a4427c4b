"""The GAN training step written out again (the port's
tpu_rvc_torch/train/step.py `TrainState._train_step`; reference
infer/modules/train/train.py:508-663): one generator forward on a random
latent slice, the multi-period discriminator's step on (real,
fake.detach()), then the generator's step against the updated
discriminator, loss = adversarial + feature matching + 45 L1(mel) + KL,
each with AdamW(lr, betas, eps, weight decay 0.01).  The forwards run
under autocast at the configuration's dtype.  The step's random draws
come from generators seeded with (train.seed, step), one a row and one
the batch shares, as the port seeds them; `generators=False` draws on
the tensors' device instead (the FLOP count, on meta)."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from .device import RowGenerators
from .discriminators import MultiPeriodDiscriminator
from .losses import discriminator_loss, feature_loss, generator_loss, kl_parts
from .mel import mel_spectrogram, spec_to_mel
from .models import synthesizer_from_config

WEIGHT_DECAY = 0.01


def row_generators(seed: int, step: int, rows, device) -> RowGenerators:
    shared = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    base = (int(seed) * 1_000_003 + int(step)) * 1_000_033
    return RowGenerators(
        [torch.Generator(device=device).manual_seed(
            (base + 1 + int(r)) % (2 ** 63)) for r in rows], shared)


class Trainer:
    """cfg: the configuration; config: the small model's config list;
    g_state/d_state: the training layouts' state dicts (None: leave the
    modules as built, on the meta device for a count)."""

    def __init__(self, cfg: Dict, config, g_state, d_state, device,
                 steps_per_epoch: int, dtype=torch.bfloat16):
        self.cfg, self.device = cfg, torch.device(device)
        self.dtype = dtype
        self.net_g = synthesizer_from_config(config, cfg["version"],
                                             bool(cfg["f0"]), train=True)
        self.net_d = MultiPeriodDiscriminator(cfg["version"])
        if g_state is not None:
            self.net_g.load_state_dict(g_state)
            self.net_d.load_state_dict(d_state)
        self.net_g.to(self.device).train()
        self.net_d.to(self.device).train()
        t = cfg["train"]
        self.opt_g, self.opt_d = (
            torch.optim.AdamW(net.parameters(), t["learning_rate"],
                              betas=tuple(t["betas"]), eps=t["eps"],
                              weight_decay=WEIGHT_DECAY)
            for net in (self.net_g, self.net_d))
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.step = 0

    def _autocast(self):
        if self.dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def lr(self) -> float:
        t = self.cfg["train"]
        return t["learning_rate"] * t["lr_decay"] ** (
            self.step // self.steps_per_epoch)

    def _update(self, opt, params, loss) -> torch.Tensor:
        torch.autograd.backward(loss, inputs=params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([p.grad for p in params])))
        for group in opt.param_groups:
            group["lr"] = self.lr()
        opt.step()
        for p in params:
            p.grad = None
        return norm

    def train_step(self, b: Dict[str, torch.Tensor], generators=True
                   ) -> Dict[str, torch.Tensor]:
        t, d = self.cfg["train"], self.cfg["data"]
        dev = self.device
        seg_frames = t["segment_size"] // d["hop_length"]
        gen = (row_generators(t["seed"], self.step,
                              range(b["phone"].shape[0]), dev)
               if generators else None)
        g_params = list(self.net_g.parameters())
        d_params = list(self.net_d.parameters())
        with self._autocast():
            y_hat, ids, _, z_mask, (z, z_p, m_p, logs_p, m_q, logs_q) = \
                self.net_g(b["phone"], b["phone_lengths"], b["spec"],
                           b["spec_lengths"], b["sid"], b["pitch"],
                           b["pitchf"], generator=gen)
        y_hat = y_hat.transpose(1, 2)
        idx = (ids.long()[:, None] * d["hop_length"]
               + torch.arange(t["segment_size"], device=dev))
        wave_slice = torch.gather(b["wave"][..., 0], 1, idx)[:, None]
        with self._autocast():
            y_dr, y_dg, _, _ = self.net_d(wave_slice, y_hat.detach())
        loss_disc = discriminator_loss(y_dr, y_dg)[0]
        grad_norm_d = self._update(self.opt_d, d_params, loss_disc)
        mel = spec_to_mel(b["spec"].float().transpose(1, 2),
                          d["filter_length"], d["n_mel_channels"],
                          d["sampling_rate"], d["mel_fmin"], d["mel_fmax"])
        fidx = ids.long()[:, None] + torch.arange(seg_frames, device=dev)
        y_mel = torch.gather(mel.transpose(1, 2), 1, fidx[:, :, None]
                             .expand(-1, -1, mel.shape[1]))
        y_hat_mel = mel_spectrogram(
            y_hat[:, 0].float(), d["filter_length"], d["n_mel_channels"],
            d["sampling_rate"], d["hop_length"], d["win_length"],
            d["mel_fmin"], d["mel_fmax"]).transpose(1, 2)
        with self._autocast():
            _, y_dg, fmap_r, fmap_g = self.net_d(wave_slice, y_hat)
        loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * t["c_mel"]
        kl_sum, mask_sum = kl_parts(z_p, logs_q, m_p, logs_p, z_mask)
        loss_kl = kl_sum / mask_sum * t["c_kl"]
        loss_fm = feature_loss(fmap_r, fmap_g)
        loss_gen = generator_loss(y_dg)[0]
        loss_gen_all = loss_gen + loss_fm + loss_mel + loss_kl
        grad_norm_g = self._update(self.opt_g, g_params, loss_gen_all)
        self.step += 1
        return {"loss_disc": loss_disc.detach(),
                "loss_gen_all": loss_gen_all.detach(),
                "grad_norm_g": grad_norm_g, "grad_norm_d": grad_norm_d}


def first_grads(opt: torch.optim.AdamW, params) -> list:
    """The gradient each parameter had at an optimizer's first step, from
    its state: AdamW's first moment is (1 - beta1) g after one step (the
    weight decay is applied to the parameter, not the moment)."""
    beta1 = opt.param_groups[0]["betas"][0]
    return [opt.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in
            opt.state.get(p, {}) else torch.zeros_like(p) for p in params]
