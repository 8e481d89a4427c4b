"""GAN losses (port of tpu_rvc/train/losses.py; reference
infer/lib/train/losses.py:4-62): LSGAN adversarial terms, feature matching
(x2) and the VITS KL divergence.  Reductions in fp32 whatever the compute
dtype; `kl_loss` takes channel-last tensors, as the JAX one does."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r: Sequence[Sequence[torch.Tensor]],
                 fmap_g: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float()
                                               - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real: Sequence[torch.Tensor],
                       disc_gen: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List, List]:
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1.0 - dr.float()) ** 2)
        g = torch.mean(dg.float() ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List]:
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_parts(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
             logs_p: torch.Tensor, z_mask: torch.Tensor):
    """`kl_loss`'s numerator, the masked sum of the KL, and its
    denominator, the mask's sum: a data-parallel step divides the sum of
    every rank's numerator by the sum of every rank's denominator."""
    z_p, logs_q = z_p.float(), logs_q.float()
    m_p, logs_p = m_p.float(), logs_p.float()
    z_mask = z_mask.float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask), torch.sum(z_mask)


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
            logs_p: torch.Tensor, z_mask: torch.Tensor) -> torch.Tensor:
    """The prior/posterior KL, channel-last (B, T, C), mask (B, T, 1)."""
    num, den = kl_parts(z_p, logs_q, m_p, logs_p, z_mask)
    return num / den
