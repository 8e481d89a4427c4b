"""Exact kNN retrieval blend (frozen from tpu_rvc_torch/retrieval/search.py;
replaces the reference's faiss IVF round trip, pipeline.py:126-138).

    d(q, x) = |q|^2 - 2 q.x + |x|^2   (|x|^2 precomputed)
    top-8 by torch.topk, inverse-square-distance weights, index_rate lerp.
"""

from __future__ import annotations

import torch


def knn_blend(feats: torch.Tensor, index_vecs: torch.Tensor,
              index_sq: torch.Tensor, index_rate, k: int = 8) -> torch.Tensor:
    """feats (..., T, D), index_vecs (N, D), index_sq (N,) -> (..., T, D):
    index_rate * blend_of_k_nearest + (1 - index_rate) * feats, every row
    against the one index."""
    f32 = feats.to(torch.float32).reshape(-1, feats.shape[-1])
    d2 = ((f32 * f32).sum(dim=1, keepdim=True)
          - 2.0 * (f32 @ index_vecs.t()) + index_sq[None, :])
    neg_d, idx = torch.topk(-d2, k, dim=1)
    weight = 1.0 / torch.square(torch.clamp(-neg_d, min=1e-12))
    weight = weight / weight.sum(dim=1, keepdim=True)
    blended = (index_vecs[idx] * weight[:, :, None]).sum(dim=1)
    out = index_rate * blended + (1.0 - index_rate) * f32
    return out.reshape(feats.shape).to(feats.dtype)
