"""Faults planted underneath the timed path, each of which `correct` has
to catch: the tests run them at a CPU's size, `calibrate.py --fault`
reads them on the card at the cell's own size.

  state_unchanged  a step that returns its state unchanged
  half_the_batch   half of the batch left out (training: the mean taken
                   over the rest; serving: half the streams handed the
                   other half's blocks)
  answer_altered   an answer altered where it is produced (a converted
                   file or a served block; a training step answers with
                   its state, which the first fault covers)
  sola_offset      serving: SOLA merges each block at its worst-matching
                   offset in the search window
  sola_no_fade     serving: SOLA merges each block without its crossfade
  coarse_pitch     offline: the coarse pitch three mel bins off the f0
                   it was quantised from
  f0_some_frames   offline: RMVPE's track an octave up on every fifth
                   frame (a fifth of the frames, the coarse pitch with it)

One card: no exchange between cards to leave out.
`plant(entry, how)` returns the function that takes the fault out."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

FAULTS: Dict[str, Tuple[str, ...]] = {
    "offline": ("answer_altered", "coarse_pitch", "f0_some_frames"),
    "serve": ("state_unchanged", "half_the_batch", "answer_altered",
              "sola_offset", "sola_no_fade"),
    "train": ("state_unchanged", "half_the_batch"),
}


def _swap(obj, name: str, value, undo: List[Callable]) -> None:
    old = getattr(obj, name)
    setattr(obj, name, value)
    undo.append(lambda: setattr(obj, name, old))


def _broken_sola(how: str) -> Callable:
    """A SOLA merge (gui.py's math) at the worst offset, or without its
    crossfade."""
    def merge(infer_wav, sola_buffer, fade_in, fade_out, block_frame,
              sola_buffer_frame, sola_search_frame, use_pv=False):
        need = block_frame + sola_buffer_frame + sola_search_frame
        if len(infer_wav) < need:
            infer_wav = np.pad(infer_wav, (0, need - len(infer_wav)))
        conv = infer_wav[:sola_buffer_frame + sola_search_frame]
        nom = np.correlate(conv, sola_buffer, mode="valid")
        den = np.sqrt(np.convolve(conv ** 2, np.ones(sola_buffer_frame),
                                  mode="valid") + 1e-8)
        k = min(len(nom), len(den))
        pick = np.argmin if how == "sola_offset" else np.argmax
        out = np.array(infer_wav[int(pick(nom[:k] / den[:k])):])
        if how != "sola_no_fade":
            out[:sola_buffer_frame] = (out[:sola_buffer_frame] * fade_in +
                                       sola_buffer * fade_out)
        return (out[:block_frame].copy(),
                out[block_frame: block_frame + sola_buffer_frame].copy())
    return merge


def plant(entry: str, how: str) -> Callable[[], None]:
    if how not in FAULTS[entry]:
        raise ValueError(f"{entry} has no fault {how!r}")
    undo: List[Callable] = []
    if how.startswith("sola_"):
        import tpu_rvc_torch.pipeline.serve as serve

        _swap(serve, "sola_merge", _broken_sola(how), undo)
    elif how in ("coarse_pitch", "f0_some_frames"):
        import tpu_rvc_torch.f0.device as f0

        post_process = f0.post_process

        def broken(f0_hz, f0_up_key, *a, **kw):
            if how == "f0_some_frames":
                f0_hz = f0_hz.clone()
                f0_hz[..., ::5] *= 2.0
            coarse, hz = post_process(f0_hz, f0_up_key, *a, **kw)
            if how == "coarse_pitch":
                coarse = torch.clamp(coarse + 3, max=255)
            return coarse, hz

        _swap(f0, "post_process", broken, undo)
    elif entry == "offline":
        import tpu_rvc_torch.pipeline.vc as vc

        to_int16 = vc._to_int16
        _swap(vc, "_to_int16", lambda out: to_int16(out * 1.01), undo)
    elif entry == "serve":
        from tpu_rvc_torch.pipeline.rt import FusedStreamGraph

        block = FusedStreamGraph._block

        def broken(self, state, seg, fed, step):
            out, new = block(self, state, seg, fed, step)
            if how == "state_unchanged":
                return out, state
            if how == "half_the_batch":
                h = out.shape[0] // 2
                return torch.cat([out[: out.shape[0] - h], out[:h]]), new
            return out * 1.01, new

        _swap(FusedStreamGraph, "_block", broken, undo)
    else:
        import tpu_rvc_torch.train.step as step

        if how == "state_unchanged":
            update = step.TrainState._update

            class NoStep:
                def __init__(self, opt):
                    self.param_groups, self.state = opt.param_groups, {}

                def step(self):
                    pass

            _swap(step.TrainState, "_update",
                  lambda self, opt, params, loss: update(
                      self, NoStep(opt), params, loss), undo)
        else:
            to_device = step.batch_to_device
            _swap(step, "batch_to_device", lambda b, dev: to_device(
                {k: v[: len(v) // 2] for k, v in b.items()}, dev), undo)

    def take_out() -> None:
        for f in reversed(undo):
            f()

    return take_out
