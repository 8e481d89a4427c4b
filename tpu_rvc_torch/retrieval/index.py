"""Feature index build, store and device residency (port of
tpu_rvc/retrieval/index.py; replaces faiss IVF + sklearn MiniBatchKMeans,
reference web.py:499-596).

Build: the stacked per-utterance HuBERT features; above 2e5 rows,
minibatch k-means on the device down to 10k centroids (reference
web.py:535-546); flat vectors and their squared norms are kept.  Storage
is the JAX package's `.tpuidx.npz` (vectors + squared norms + metadata) or
the reference's flat `total_fea.npy`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from tpu_rvc_torch.core.device import resolve_device

KMEANS_THRESHOLD = 200_000  # reference web.py:535: k-means above 2e5 rows
KMEANS_CLUSTERS = 10_000


@torch.no_grad()
def train_kmeans(x: np.ndarray, k: int = KMEANS_CLUSTERS, iters: int = 20,
                 batch: int = 8192, seed: int = 0, device=None) -> np.ndarray:
    """Minibatch k-means on `device` (default "cuda") -> (k, D) float32
    centroids.  The initial rows and every epoch's order come from
    numpy's `default_rng(seed)`, drawn in the JAX package's order, so both
    packages see the same batches.  Products run in full fp32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    cent = torch.as_tensor(x[rng.choice(n, size=k, replace=False)],
                           dtype=torch.float32, device=dev)
    cnt = torch.ones(k, dtype=torch.float32, device=dev)
    matmul = torch.backends.cuda.matmul
    saved, matmul.allow_tf32 = matmul.allow_tf32, False
    try:
        for _ in range(iters):
            order = rng.permutation(n)
            for s in range(0, n, batch):
                xb = torch.as_tensor(x[order[s:s + batch]],
                                     dtype=torch.float32, device=dev)
                d2 = ((xb * xb).sum(1, keepdim=True) - 2 * xb @ cent.t()
                      + (cent * cent).sum(1)[None, :])
                assign = torch.argmin(d2, dim=1)
                batch_counts = torch.zeros_like(cnt).index_add_(
                    0, assign, torch.ones_like(assign, dtype=torch.float32))
                batch_sums = torch.zeros_like(cent).index_add_(0, assign, xb)
                cnt = cnt + batch_counts
                lr = batch_counts / torch.clamp(cnt, min=1.0)
                mean = batch_sums / torch.clamp(batch_counts, min=1.0)[:, None]
                cent = torch.where(batch_counts[:, None] > 0,
                                   cent + lr[:, None] * (mean - cent), cent)
    finally:
        matmul.allow_tf32 = saved
    return cent.cpu().numpy()


@dataclasses.dataclass
class FeatureIndex:
    vectors: np.ndarray        # (N, D) float32
    norms_sq: np.ndarray       # (N,)
    version: str = "v2"
    kmeans_compressed: bool = False

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def device_arrays(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vectors, norms_sq) on `device`, uploaded once and cached: the
        index is queried by every chunk."""
        cache = self.__dict__.setdefault("_device_cache", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = (
                torch.as_tensor(self.vectors, dtype=torch.float32).to(device),
                torch.as_tensor(self.norms_sq, dtype=torch.float32).to(device))
        return cache[key]

    def save(self, path: str, write_big_npy: bool = False) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 vectors=self.vectors.astype(np.float32),
                 norms_sq=self.norms_sq.astype(np.float32),
                 version=np.asarray(self.version),
                 kmeans=np.asarray(self.kmeans_compressed))
        if write_big_npy:
            np.save(str(Path(path).with_suffix("")) + "_total_fea.npy",
                    self.vectors)

    @classmethod
    def load(cls, path: str) -> "FeatureIndex":
        if path.endswith(".npy"):  # reference total_fea.npy
            vecs = np.load(path).astype(np.float32)
            return cls(vecs, (vecs * vecs).sum(1))
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        return cls(z["vectors"], z["norms_sq"], str(z["version"]),
                   bool(z["kmeans"]))


def build_index(features: np.ndarray, version: str = "v2",
                kmeans_threshold: int = KMEANS_THRESHOLD, seed: int = 0,
                device=None) -> FeatureIndex:
    """A retrieval index from (N, D) HuBERT features; more rows than
    `kmeans_threshold` are compressed to centroids on `device`."""
    feats = np.ascontiguousarray(features, dtype=np.float32)
    compressed = False
    if feats.shape[0] > kmeans_threshold:
        feats = train_kmeans(feats, KMEANS_CLUSTERS, seed=seed, device=device)
        compressed = True
    return FeatureIndex(feats, (feats * feats).sum(axis=1), version,
                        compressed)
