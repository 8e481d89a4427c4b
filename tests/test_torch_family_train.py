"""tpu_rvc_torch's GAN training at the model family's geometries against
tpu_rvc's (JAX) on the CPU, as tests/test_torch_train.py holds the tiny
16 kHz model: one seeded port trainer's weights carried into the JAX
trees through the reference layout, the same seeded numpy batch through
both, fp32.  Two narrow geometries keep each preset's hop, FFT size, mel
count, upsample rates and kernel sizes, its three resblocks and its
discriminator:

  v1_32k_f0   five decoder levels (the second at C = 16), 256-d phone
              input, nfft 1024 / hop 320 / 80 mels, the v1 MPD;
  v2_40k      no f0 (the plain HiFiGAN decoder, no pitch keys in the
              batch), nfft 2048 / hop 400 / 125 mels, the v2 MPD.

The segment is cut to 12 frames (the presets' 40 and 32 frames train
the same graph on longer rows; `BucketBatcher`'s plans at the presets'
segments are held in tests/test_torch_family_data.py).

The narrow decoders' upsamplers start at 30x their initial gain, as
tests/test_torch_presets.py scales them: at 1x a narrow random decoder's
output barely depends on its input, its first level's gradients are
1e-6 of conv_post's, and fp32 rounding alone (the port's own fp32 step
against its fp64 step) moves 0.36% of G's parameters more than 1e-6
after one step, above the step criterion's 0.1%; at 30x, 0.004%."""

import dataclasses
import functools
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.ckpt.convert import (discriminator_params_from_state_dict,
                                  synthesizer_params_from_state_dict)
from tpu_rvc.core import config as jax_config
from tpu_rvc.ops import mel as jax_mel
from tpu_rvc.train.step import create_train_state as jax_create_train_state
from tpu_rvc.train.step import make_train_step

from tpu_rvc_torch.ckpt.convert import train_state_from_jax
from tpu_rvc_torch.core import config
from tpu_rvc_torch.ops import mel
from tpu_rvc_torch.train.step import create_train_state

from _torch_parity import single_threaded_child

B, T, SEG_FRAMES = 2, 16, 12
IDS = np.array([3, 1], np.int32)
LENGTHS = np.array([T, 14], np.int32)
UPS_GAIN = 30.0
KINDS = {"v1_32k_f0": ("v1", 32000, True), "v2_40k": ("v2", 40000, False)}
TERMS = ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_kl",
         "loss_gen_all", "grad_norm_g", "grad_norm_d")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes and
    a GAN step with the default pool in each of them oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow(cfg, version, sr):
    """The preset of `cfg` (either package's config module) at narrow
    width: enc_p one layer of 16 channels, the decoder from 64 channels
    (32, 16, 8, 4 and, at five levels, 2), the preset's data geometry,
    upsample rates, kernel sizes and resblocks; fp32."""
    hp = cfg.hparams_for(version, sr)
    return dataclasses.replace(
        hp,
        train=dataclasses.replace(
            hp.train, segment_size=SEG_FRAMES * hp.data.hop_length,
            batch_size=B, fp16_run=False),
        model=dataclasses.replace(
            hp.model, inter_channels=16, hidden_channels=16,
            filter_channels=32, n_layers=1, upsample_initial_channel=64,
            gin_channels=8, spk_embed_dim=4))


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def make_batch(hp, use_f0, rng):
    """A seeded batch of the JAX layout with unequal lengths, the slice
    and the posterior draw pinned; f0-less batches carry no pitch."""
    batch = {
        "phone": rng.standard_normal((B, T, hp.encoder_dim)).astype(
            np.float32),
        "phone_lengths": LENGTHS,
        "spec": rng.standard_normal((B, T, hp.data.spec_channels)).astype(
            np.float32),
        "spec_lengths": LENGTHS,
        "wave": rng.standard_normal(
            (B, T * hp.data.hop_length, 1)).astype(np.float32) * 0.1,
        "sid": np.array([0, 3], np.int32),
        "pin_ids_slice": IDS,
        "pin_noise_eps": rng.standard_normal(
            (B, T, hp.model.inter_channels)).astype(np.float32),
    }
    if use_f0:
        batch["pitch"] = rng.integers(1, 255, (B, T)).astype(np.int32)
        batch["pitchf"] = rng.uniform(100, 300, (B, T)).astype(np.float32)
    return batch


def numpy_state(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def port_trainer(kind):
    """The kind's seeded port trainer, its upsamplers at UPS_GAIN, and its
    pinned batch: the same in every process."""
    version, sr, use_f0 = KINDS[kind]
    hp = narrow(config, version, sr)
    state = create_train_state(hp, seed=3, use_f0=use_f0, device="cpu")
    with torch.no_grad():
        for up in state.net_g.dec.ups:
            up.weight_g.mul_(UPS_GAIN)
    return hp, state, make_batch(hp, use_f0, np.random.default_rng(5))


def jax_side(kind, part):
    """tpu_rvc's side of a kind, `part` "forward" or "step", each in a
    process of its own, from the port trainer's initial weights carried
    over the reference layout: its forward on the pinned batch, or two
    pinned steps of its jitted step (both compiled at XLA's backend
    optimization level 0, which halves the step's compile here and gave
    the same losses bit for bit) -> the forward, or each step's metrics
    and the weights after step 1 in the port's layout."""
    single_threaded_child()
    version, sr, use_f0 = KINDS[kind]
    hp, state, batch = port_trainer(kind)
    m = hp.model
    g = synthesizer_params_from_state_dict(
        numpy_state(state.net_g), n_layers=m.n_layers,
        n_ups=len(m.upsample_rates), num_kernels=len(m.resblock_kernel_sizes),
        use_f0=use_f0, has_enc_q=True, fold_weight_norm=False, strict=True)
    d = discriminator_params_from_state_dict(numpy_state(state.net_d),
                                             version=version)
    del state
    jstate, net_g, net_d = jax_create_train_state(
        narrow(jax_config, version, sr), jax.random.PRNGKey(0), g_params=g,
        d_params=d, use_f0=use_f0)
    level0 = {"xla_backend_optimization_level": 0}
    if part == "forward":
        pitch = (batch["pitch"], batch["pitchf"]) if use_f0 else ()
        forward = jax.jit(functools.partial(net_g.apply, deterministic=True),
                          compiler_options=level0)(
            {"params": g}, batch["phone"], batch["phone_lengths"],
            batch["spec"], batch["spec_lengths"], batch["sid"], *pitch,
            ids_slice=IDS, noise_eps=batch["pin_noise_eps"])
        return jax.device_get(forward)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    step = make_train_step(net_g, net_d, narrow(jax_config, version, sr),
                           donate=False).lower(jstate, jbatch, key).compile(
        compiler_options=level0)
    wants, after_1 = [], None
    for i in range(2):
        jstate, want = step(jstate, jbatch, key)
        wants.append(jax.device_get(want))
        if i == 0:
            after_1 = train_state_from_jax(jax.device_get(jstate.g_params),
                                           jax.device_get(jstate.d_params),
                                           version)
    return dict(wants=wants, after_1=after_1)


def port_side(hp, state, batch, use_f0):
    """The port's forward on the pinned batch, and two pinned steps of a
    fresh trainer on the same weights -> the forward, each step's
    metrics, the weights after step 1."""
    pitch = ((t(batch["pitch"]), t(batch["pitchf"])) if use_f0 else ())
    with torch.no_grad():
        forward = state.net_g(
            t(batch["phone"]), t(batch["phone_lengths"]), t(batch["spec"]),
            t(batch["spec_lengths"]), t(batch["sid"]), *pitch,
            ids_slice=t(IDS), noise_eps=t(batch["pin_noise_eps"]),
            deterministic=True)
    fresh = create_train_state(hp, device="cpu", use_f0=use_f0,
                               g_state=state.net_g.state_dict(),
                               d_state=state.net_d.state_dict())
    gots, after_1 = [], None
    for i in range(2):
        gots.append(fresh.train_step(batch))
        if i == 0:
            after_1 = tuple({k: v.clone() for k, v in net.state_dict().items()}
                            for net in (fresh.net_g, fresh.net_d))
    return dict(forward=forward, gots=gots, after_1=after_1,
                steps=fresh.step)


@pytest.fixture(scope="module")
def worlds(one_torch_thread):
    """Each kind's port trainer, batch and results; tpu_rvc's side of
    every kind starts first, its forward and its steps each in a spawned
    process of their own (tracing the JAX step holds the interpreter lock
    for tens of seconds), and runs while the port's side runs here."""
    parts = ("forward", "step")
    with ProcessPoolExecutor(len(KINDS) * len(parts),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {kind: {part: pool.submit(jax_side, kind, part)
                          for part in parts} for kind in KINDS}
        out = {}
        for kind, (version, _, use_f0) in KINDS.items():
            hp, state, batch = port_trainer(kind)
            out[kind] = dict(kind=kind, hp=hp, version=version,
                             use_f0=use_f0, state=state, batch=batch,
                             port=port_side(hp, state, batch, use_f0),
                             jax=futures[kind])
        yield out


@pytest.fixture(params=list(KINDS))
def world(worlds, request):
    return worlds[request.param]


def test_family_geometry(world):
    """The narrow models keep what the kind's preset trains with."""
    hp, state = world["hp"], world["state"]
    n_levels = len(hp.model.upsample_rates)
    assert state.net_g.use_f0 is world["use_f0"]
    assert state.net_g.enc_p.emb_phone.in_features == hp.encoder_dim
    assert state.net_g.enc_q.pre.in_channels == hp.data.spec_channels
    assert len(state.net_g.dec.resblocks) == 3 * n_levels
    widths = [64 // 2 ** (i + 1) for i in range(n_levels)]
    assert 16 in widths
    if world["kind"] == "v1_32k_f0":
        assert (n_levels, hp.encoder_dim, hp.data.spec_channels,
                hp.data.n_mel_channels) == (5, 256, 513, 80)
        assert len(state.net_d.discriminators) == 7   # S + periods 2-17
    else:
        assert (n_levels, hp.encoder_dim, hp.data.spec_channels,
                hp.data.n_mel_channels) == (4, 768, 1025, 125)
        assert len(state.net_d.discriminators) == 9   # S + periods 2-37


def test_family_forward_matches_jax(world):
    """`Synthesizer.forward` with the slice and the posterior draw
    pinned: the segment's audio to 1e-4, every latent to atol 1e-5 /
    rtol 1e-4."""
    hp, got = world["hp"], world["port"]["forward"]
    want = world["jax"]["forward"].result()
    assert got[0].shape == (B, hp.train.segment_size, 1)
    close(got[0], want[0], rtol=0, atol=1e-4, what="audio")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name, x, y in zip(("z", "z_p", "m_p", "logs_p", "m_q", "logs_q"),
                          got[4], want[4]):
        close(x, y, what=name)


@pytest.mark.parametrize("version,sr", [("v1", 32000), ("v2", 40000),
                                        ("v1", 48000)])
def test_family_spectrogram_and_mel_match_jax(version, sr):
    """The training spectrogram and mel at the preset's FFT size, hop and
    mel count (1024/320/80, 2048/400/125, 2048/480/128), reference
    padding, over two segments with digital silence in one."""
    d = config.hparams_for(version, sr).data
    y = np.random.default_rng(sr).standard_normal(
        (2, 16 * d.hop_length)).astype(np.float32) * 0.3
    y[1, d.hop_length:4 * d.hop_length] = 0.0
    spec = mel.spectrogram(t(y), d.filter_length, d.hop_length, d.win_length)
    assert spec.shape[1] == d.spec_channels
    close(spec, jax_mel.spectrogram(jnp.asarray(y), d.filter_length,
                                    d.hop_length, d.win_length))
    args = (d.filter_length, d.n_mel_channels, d.sampling_rate)
    close(mel.spec_to_mel(spec, *args),
          jax_mel.spec_to_mel(jnp.asarray(spec.numpy()), *args))
    close(mel.mel_spectrogram(t(y), *args, d.hop_length, d.win_length),
          jax_mel.mel_spectrogram(jnp.asarray(y), *args, d.hop_length,
                                  d.win_length))


def test_family_train_step_matches_jax(world):
    """Two pinned D-then-G steps against tpu_rvc's jitted step, with the
    criterion of tests/test_torch_train.py `test_train_step_matches_jax`:
    every loss term and both grad norms within 1e-3 relative at both
    steps; after step 1 every parameter within 2 lr of the JAX one, under
    0.1% of them off by more than 1e-6."""
    hp, port = world["hp"], world["port"]
    assert port["steps"] == 2
    jax_run = world["jax"]["step"].result()
    lr = hp.train.learning_rate
    for i, (got, want) in enumerate(zip(port["gots"], jax_run["wants"])):
        for k in TERMS:
            w, g = float(want[k]), float(got[k])
            assert np.isfinite(g), k
            assert abs(g - w) <= 1e-3 * abs(w), f"step {i + 1} {k}: {g} vs {w}"
        assert got["mel_org"].shape == (SEG_FRAMES, hp.data.n_mel_channels)
        close(got["mel_org"], want["mel_org"], what="mel_org")
    for own, ref in zip(port["after_1"], jax_run["after_1"]):
        assert set(own) == set(ref)
        diff = torch.cat([(own[k] - ref[k]).abs().flatten() for k in own])
        assert float(diff.max()) <= 2 * lr * 1.01, float(diff.max())
        assert float((diff > 1e-6).float().mean()) < 1e-3
