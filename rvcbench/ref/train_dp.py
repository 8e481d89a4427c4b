"""The data-parallel training step written out again: each process of a
group holds rows `rank::world` of the global batch and takes the step of
the whole batch (the port's tpu_rvc_torch/train/step.py with a group;
reference infer/modules/train/train.py under DistributedDataParallel).

`SliceTrainer` is the reference `Trainer` on one slice, with three
differences, each what the global batch's step needs:
- the random draws of local row j come from global row j * world + rank's
  generator, so the slices together draw what one process draws for the
  whole batch;
- the KL is the global batch's: this slice's masked sum over the group's
  mask sum, times the group's size, which the mean of the gradients
  divides out again;
- each gradient is averaged over the group by an all-reduce of its own
  (no flat buffers), before the norms and AdamW; the returned losses are
  the group's means, and `rank_loss_disc`/`rank_loss_gen_all` this
  slice's own.
Every other loss is a mean over equal slices, so the mean of the slices'
gradients is the whole batch's."""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .losses import discriminator_loss, feature_loss, generator_loss, kl_parts
from .mel import mel_spectrogram, spec_to_mel
from .train import Trainer, row_generators


class SliceTrainer(Trainer):
    def __init__(self, cfg: Dict, config, g_state, d_state, device,
                 steps_per_epoch: int, group, dtype=torch.bfloat16):
        super().__init__(cfg, config, g_state, d_state, device,
                         steps_per_epoch, dtype)
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.group)
        return x.div_(self.world)

    def _update(self, opt, params, loss) -> torch.Tensor:
        torch.autograd.backward(loss, inputs=params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._mean(p.grad)
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
        rows = [j * self.world + self.rank for j in range(b["phone"].shape[0])]
        gen = row_generators(t["seed"], self.step, rows, dev)
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
        mask_all = mask_sum.detach().clone()
        dist.all_reduce(mask_all, group=self.group)
        loss_kl = kl_sum * self.world / mask_all * t["c_kl"]
        loss_fm = feature_loss(fmap_r, fmap_g)
        loss_gen = generator_loss(y_dg)[0]
        loss_gen_all = loss_gen + loss_fm + loss_mel + loss_kl
        grad_norm_g = self._update(self.opt_g, g_params, loss_gen_all)
        self.step += 1
        losses = self._mean(torch.stack([loss_disc.detach(),
                                         loss_gen_all.detach()]))
        return {"loss_disc": losses[0], "loss_gen_all": losses[1],
                "rank_loss_disc": loss_disc.detach(),
                "rank_loss_gen_all": loss_gen_all.detach(),
                "grad_norm_g": grad_norm_g, "grad_norm_d": grad_norm_d}
