"""Feature index load and device residency (port of
tpu_rvc/retrieval/index.py:62-101).  Building an index (k-means
compression) is not part of this port yet.

Storage is the JAX package's `.tpuidx.npz` (vectors + squared norms +
metadata) or the reference's flat `total_fea.npy`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


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

    @classmethod
    def load(cls, path: str) -> "FeatureIndex":
        if path.endswith(".npy"):  # reference total_fea.npy
            vecs = np.load(path).astype(np.float32)
            return cls(vecs, (vecs * vecs).sum(1))
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        return cls(z["vectors"], z["norms_sq"], str(z["version"]),
                   bool(z["kmeans"]))
