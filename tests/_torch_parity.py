"""Shared helpers of the tpu_rvc_torch parity tests.

Weights start as a seeded tpu_rvc_torch model, are written out in the
reference torch layout (weight norm as (g, v) where the reference keeps
it, fairseq names for HuBERT) and go from there into both packages
through their own loaders: tpu_rvc's `synthesizer_params_from_state_dict`
/ `hubert_params_from_fairseq`, tpu_rvc_torch's
`synthesizer_state_from_reference` / `hubert_state_from_fairseq`.

`serving_world` / `engine_pair` / `scheduler_pair` carry one set of small
weights into both packages' realtime engines and multi-stream schedulers,
both deterministic (no prior or source noise), for the serving tests.
"""

import os
import re

import numpy as np
import torch

from tpu_rvc.ckpt.convert import synthesizer_params_from_state_dict
from tpu_rvc.ckpt.hubert_loader import hubert_params_from_fairseq
from tpu_rvc.ckpt.rmvpe_loader import rmvpe_params_from_torch
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.models.rmvpe import E2E as JaxE2E
from tpu_rvc.models.synthesizer import Synthesizer as JaxSynthesizer
from tpu_rvc.pipeline import rt as jax_rt
from tpu_rvc.pipeline import serve as jax_serve
from tpu_rvc.retrieval.index import FeatureIndex as JaxIndex
from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.ckpt.hubert_loader import hubert_state_from_fairseq
from tpu_rvc_torch.ckpt.rmvpe_loader import (random_rmvpe_reference_state,
                                             rmvpe_state_from_reference)
from tpu_rvc_torch.models.hubert import Hubert
from tpu_rvc_torch.models.rmvpe import E2E
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline import rt, serve
from tpu_rvc_torch.retrieval.index import FeatureIndex

SMALL_HUBERT = dict(output_layer=2, final_proj=False, embed=64, ffn_dim=128,
                    n_heads=2, pos_conv_k=16, pos_conv_groups=2,
                    conv_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4),
                                 (32, 2, 2), (32, 2, 2)))  # 320x downsample

SMALL_SYNTH = dict(
    spec_channels=129, segment_size=640, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="1",
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
    upsample_rates=(10, 16), upsample_initial_channel=64,
    upsample_kernel_sizes=(20, 32), spk_embed_dim=2, gin_channels=16,
    sr=16000, encoder_dim=64, use_f0=True)

TINY = dict(n_blocks=1, n_gru=1, en_de_layers=2, inter_layers=1,
            en_out_channels=4)   # the E2E tests/test_pipeline.py:241 drives
FULL = dict(n_blocks=4, n_gru=1, en_de_layers=5, inter_layers=4,
            en_out_channels=16)  # E2E(4, 1, (2, 2)), the rmvpe.pt shape

# the convs the reference keeps under weight norm
_WEIGHT_NORM = re.compile(r"^(dec\.ups\.|dec\.resblocks\.|flow\.flows\.\d+"
                          r"\.enc\.(in_layers|res_skip_layers|cond_layer))")


def single_threaded_child():
    """In a spawned child of a test, before its first JAX operation: one
    torch thread and one XLA CPU thread (XLA reads its flags when its
    backend starts), so that the child does not take the cores the
    suite's workers share; its JAX step ran no slower so on this CPU."""
    torch.set_num_threads(1)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1").strip()


def seeded(cls, seed, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(**kw).eval()


def reference_state(net: Synthesizer, seed: int):
    """The port model's weights in the reference layout, numpy, with the
    weight-normed convs split into (g, v): v is a rescaled copy of the
    weight and g carries a random gain, so folding is exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, w in net.state_dict().items():
        w = w.numpy().astype(np.float32)
        if k.endswith(".weight") and _WEIGHT_NORM.match(k):
            base = k[:-len(".weight")]
            norm = np.sqrt((w * w).sum(axis=tuple(range(1, w.ndim)),
                                       keepdims=True))
            out[base + ".weight_v"] = w * 3.0
            out[base + ".weight_g"] = (norm * rng.uniform(
                0.8, 1.2, norm.shape)).astype(np.float32)
        else:
            out[k] = w
    return out


def jax_synth_params(sd, cfg):
    """tpu_rvc params (with (g, v)) from a reference-layout state_dict."""
    return {"params": synthesizer_params_from_state_dict(
        sd, n_layers=cfg["n_layers"], n_ups=len(cfg["upsample_rates"]),
        num_kernels=len(cfg["resblock_kernel_sizes"]),
        use_f0=cfg["use_f0"], fold_weight_norm=False)}


def hubert_pair(cfg, seed):
    """(port Hubert, tpu_rvc Hubert variables) with the same weights,
    carried over a fairseq-layout state_dict."""
    port = seeded(Hubert, seed, **cfg)
    sd = dict(port.state_dict())
    w = sd.pop("encoder.pos_conv.0.weight")
    g = torch.sqrt((w * w).sum(dim=(0, 1), keepdim=True))
    sd["encoder.pos_conv.0.weight_g"] = g
    sd["encoder.pos_conv.0.weight_v"] = w
    port.load_state_dict(hubert_state_from_fairseq(
        sd, cfg["output_layer"], cfg["final_proj"]))
    params = hubert_params_from_fairseq(
        {k: v.numpy() for k, v in sd.items()}, cfg["output_layer"],
        cfg["final_proj"])
    return port, {"params": params}


def e2e_pair(kw, seed):
    """(port E2E, JAX E2E, JAX variables) from one reference-layout state
    dict with non-trivial BatchNorm statistics."""
    sd = random_rmvpe_reference_state(seed, **kw)
    port = E2E(**kw).eval()
    port.load_state_dict(rmvpe_state_from_reference(sd))
    params = rmvpe_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, kw["n_blocks"],
        kw["en_de_layers"], kw["inter_layers"])
    return port, JaxE2E(**kw), {"params": params}


# ---------------------------------------------------------------------------
# serving: one set of weights in both packages' engines and schedulers
# ---------------------------------------------------------------------------

# the sizes of tests/test_serve.py:26-39
SERVE_HUBERT = dict(output_layer=1, final_proj=False, embed=64, ffn_dim=64,
                    n_heads=2, pos_conv_k=16, pos_conv_groups=2,
                    conv_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4),
                                 (32, 2, 2), (32, 2, 2)))
SERVE_SYNTH = dict(
    spec_channels=129, segment_size=640, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="1",
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
    upsample_rates=(10, 16), upsample_initial_channel=32,
    upsample_kernel_sizes=(20, 32), spk_embed_dim=2, gin_channels=16,
    sr=16000, encoder_dim=64, use_f0=True)
# 16 kHz, 160 ms blocks, 0.64 s of context (tests/test_serve.py:69-78)
SERVE_GEOMETRY = dict(samplerate=16000, block_time=0.16, crossfade_time=0.04,
                      extra_time=0.64)


class DeterministicJaxSynthesizer(JaxSynthesizer):
    """tpu_rvc's engines call `infer` with its defaults and so always draw
    prior noise from a JAX key, which torch cannot reproduce: this one
    zeroes every random term, as the port's engines do when built with
    deterministic=True and noise_scale=0."""

    def infer(self, *args, **kw):
        kw.update(deterministic=True, noise_scale=0.0)
        return JaxSynthesizer.infer(self, *args, **kw)


class FakeClock:
    """A monotonic clock advanced by hand: a tick on the CPU is slower than
    the 160 ms block, so wall time would fake starvation."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def stream_voice(n, seed=0, sr=16000, f0=200.0):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(f0 + 50 * np.sin(2 * np.pi * 0.8 * tt)) / sr
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 0.005 * rng.standard_normal(n)).astype(np.float32)


def serving_world(seed=61):
    """Both packages' models from one set of weights, and both indexes.
    The upsamplers are scaled 30x from their initialisation, so that the
    audio depends on the input and SOLA's offsets do not tie (see
    tests/test_torch_realtime.py `world`)."""
    seed_net = seeded(Synthesizer, seed, **SERVE_SYNTH)
    with torch.no_grad():
        for up in seed_net.dec.ups:
            up.weight.mul_(30.0)
    sd = reference_state(seed_net, seed + 1)
    synth = Synthesizer(**SERVE_SYNTH).eval()
    synth.load_state_dict(synthesizer_state_from_reference(sd))
    hub, jax_hub_vars = hubert_pair(SERVE_HUBERT, seed + 2)
    vecs = np.random.default_rng(seed + 3).standard_normal((300, 64)).astype(
        np.float32)
    return dict(
        synth=synth, hub=hub, index=FeatureIndex(vecs, (vecs * vecs).sum(1)),
        jax_hub=JaxHubert(**SERVE_HUBERT), jax_hub_vars=jax_hub_vars,
        jax_synth=DeterministicJaxSynthesizer(**SERVE_SYNTH,
                                              weight_norm=True),
        jax_synth_vars=jax_synth_params(sd, SERVE_SYNTH),
        jax_index=JaxIndex(vecs, (vecs * vecs).sum(1)))


def engine_pair(world, index_rate=0.0, n_streams=None, **kw):
    """(port engine on the CPU, JAX engine), fresh, deterministic; with
    `n_streams` both are BatchedRealtimeVC."""
    w = world
    port_kw = dict(hubert=w["hub"], synth=w["synth"], version="v2", if_f0=1,
                   index=w["index"] if index_rate else None,
                   index_rate=index_rate, noise_scale=0.0,
                   deterministic=True, device="cpu", **kw)
    jax_kw = dict(hubert=w["jax_hub"], hubert_vars=w["jax_hub_vars"],
                  synth=w["jax_synth"], synth_vars=w["jax_synth_vars"],
                  version="v2", if_f0=1,
                  index=w["jax_index"] if index_rate else None,
                  index_rate=index_rate, **kw)
    if n_streams is None:
        return rt.RealtimeVC(**port_kw), jax_rt.RealtimeVC(**jax_kw)
    return (rt.BatchedRealtimeVC(n_streams, **port_kw),
            jax_rt.BatchedRealtimeVC(n_streams, **jax_kw))


def scheduler_pair(world, n_slots=2, f0method="pm", jax_graph=None, **kw):
    """(port SlotScheduler, JAX SlotScheduler, the clock both read).
    `jax_graph`, a FusedStreamGraph of the same geometry that is compiled
    already, replaces the JAX scheduler's own (and takes its engine)."""
    clock = FakeClock()
    port, jeng = engine_pair(world)
    args = dict(n_slots=n_slots, f0method=f0method, clock=clock,
                **SERVE_GEOMETRY, **kw)
    sched = serve.SlotScheduler(port, **args)
    jsched = jax_serve.SlotScheduler(jeng, **args)
    if jax_graph is not None:
        jsched.fused, jsched.engine = jax_graph, jax_graph.engine
    return sched, jsched, clock


def spy_chunks(pipe, store):
    """Make `pipe` (either package's Pipeline) record, as float64 numpy, the
    float audio every vc_chunk returns: the host path's output before its
    RMS mix and int16 scaling.  Returns the method it wraps, for the
    caller to put back."""
    inner = pipe.vc_chunk

    def spy(*args, **kw):
        out = inner(*args, **kw)
        store.append(out.double().numpy() if torch.is_tensor(out)
                     else np.asarray(out, np.float64))
        return out

    pipe.vc_chunk = spy
    return inner
