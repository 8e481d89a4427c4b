"""Batched conversion of B same-length utterances over a device mesh
(port of tpu_rvc/parallel/batch.py:26-120).

The JAX package vmaps its fused single-utterance graph and shards the
batch over the mesh's `data` axis in one SPMD dispatch.  Here the B rows
are split into one block a data shard; each shard converts its block
with `Pipeline._full_rows` (f0 on the device, HuBERT with a padding mask
a row, the retrieval blend, `Synthesizer.infer` with a key length a row,
the decoder's stage kernel over the rows as its stream axis, RMS mix and
int16 a row) on its replica of the pipeline (`core/mesh.py` `replicas`),
and the int16 rows come back in order.  Row i draws its noise from a
generator seeded `noise_seed + i`, as the JAX package's row keys are
`PRNGKey(noise_seed + i)`.
"""

from __future__ import annotations

import numpy as np

from tpu_rvc_torch.core.mesh import (Mesh, gather_rows, replicas,
                                     shard_bounds, split_rows)
from tpu_rvc_torch.f0.device import DEVICE_F0


def batch_convert(pipeline, audio_batch: np.ndarray, sids, mesh: Mesh, *,
                  f0_up_key: float = 0.0, f0_method: str = "pm", index=None,
                  index_rate: float = 0.0, protect: float = 0.33,
                  rms_mix_rate: float = 0.25, noise_seed: int = 0
                  ) -> np.ndarray:
    """Convert B pre-padded utterances (B, L) at 16 kHz in one batch over
    the mesh.  B must be a multiple of the mesh's `data` axis.  Inputs are
    reflect-padded already, `pipeline.t_pad` a side, as
    `Pipeline.pipeline` pads them; rows come back int16 at
    `pipeline.tgt_sr` with the pads trimmed.  f0 is pm, rmvpe or fcpe on
    the device; an estimator without its weights raises (the JAX package
    quietly runs pm for FCPE there)."""
    audio_batch = np.asarray(audio_batch, np.float32)
    B = audio_batch.shape[0]
    bounds = shard_bounds(B, mesh)  # raises unless B divides over the mesh
    use_f0 = pipeline.synth.use_f0
    has_index = index is not None and index_rate > 0
    f0_mode = f0_method if use_f0 else "pm"
    if use_f0 and f0_mode not in DEVICE_F0:
        raise ValueError(f"f0 method {f0_mode} has no fused device variant")
    if use_f0 and f0_mode in ("rmvpe", "fcpe"):
        pipeline.f0_gen._get(f0_mode)   # FileNotFoundError without weights
    if not (use_f0 and protect < 0.5):
        protect = 1.0   # the protect mask off
    sids = np.asarray(sids, np.int64)
    seeds = noise_seed + np.arange(B)
    parts = []
    for rows, block, rep in zip(bounds, split_rows(audio_batch, mesh),
                                replicas(pipeline, mesh)):
        arrays = index.device_arrays(rep.device) if has_index else None
        parts.append(rep._full_rows(
            block, float(f0_up_key), sids[rows].tolist(), use_f0, arrays,
            index_rate, protect, rms_mix_rate,
            [rep._generator(s) for s in seeds[rows]], f0_mode))
    return gather_rows(parts).numpy()


def make_batch_graph(pipeline, L: int, mesh: Mesh):
    """The JAX package's name for its compiled batch graph.  Eager PyTorch
    compiles nothing, so this is `batch_convert` over `mesh` for rows of
    L samples: run(audio (B, L), sids, **options) -> int16 (B, samples)."""
    def run(audio_batch, sids, **options):
        if np.shape(audio_batch)[1] != L:
            raise ValueError(f"rows of {np.shape(audio_batch)[1]} samples, "
                             f"not {L}")
        return batch_convert(pipeline, audio_batch, sids, mesh, **options)

    return run
