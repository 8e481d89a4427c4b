"""tpu_rvc_torch's training modules and GAN step against tpu_rvc's (JAX) on
the CPU: the weights of one seeded port trainer carried into the JAX tree
through the reference layout (weight norm as (g, v), enc_q kept), the same
seeded numpy inputs through both, fp32, tolerances stated per test.  Also
the kernel guard, the gradient reaching enc_p's attention and every
resblock, the stage-weight cache under in-place updates, and the trained
generator against its exported small model."""

import dataclasses
import functools
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.ckpt.convert import (discriminator_params_from_state_dict,
                                  synthesizer_params_from_state_dict)
from tpu_rvc.core import config as jax_config
from tpu_rvc.nn.discriminators import MultiPeriodDiscriminator as JaxMPD
from tpu_rvc.nn.encoders import PosteriorEncoder as JaxPosterior
from tpu_rvc.nn.flows import ResidualCouplingBlock as JaxFlow
from tpu_rvc.ops import mel as jax_mel
from tpu_rvc.train import losses as jax_losses
from tpu_rvc.train.step import create_train_state as jax_create_train_state
from tpu_rvc.train.step import make_train_step

from tpu_rvc_torch.ckpt.convert import train_state_from_jax
from tpu_rvc_torch.core import config
from tpu_rvc_torch.models.loader import load_synthesizer
from tpu_rvc_torch.models.synthesizer import make_synthesizer
from tpu_rvc_torch.nn.discriminators import MultiPeriodDiscriminator
from tpu_rvc_torch.ops import mel
from tpu_rvc_torch.ops.kernels import (banded_rel_attention, fused_resblock,
                                       fused_stage, pack_stage)
from tpu_rvc_torch.train import losses
from tpu_rvc_torch.train.step import create_train_state

from _torch_parity import single_threaded_child

B, T = 2, 24
IDS = np.array([3, 7], np.int32)
LENGTHS = np.array([T, 19], np.int32)


def tiny(cfg):
    """TINY_HP of tests/test_train.py, built from a package's config."""
    return cfg.HParams(
        version="v1",
        train=cfg.TrainConfig(segment_size=1600, batch_size=2,
                              fp16_run=False),
        data=cfg.DataConfig(sampling_rate=16000, filter_length=256,
                            hop_length=160, win_length=256,
                            n_mel_channels=32),
        model=cfg.ModelConfig(
            inter_channels=32, hidden_channels=32, filter_channels=64,
            n_heads=2, n_layers=1, kernel_size=3,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
            upsample_rates=(10, 16), upsample_initial_channel=64,
            upsample_kernel_sizes=(20, 32), gin_channels=16,
            spk_embed_dim=4))


HP, JAX_HP = tiny(config), tiny(jax_config)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on one machine: a GAN
    step with torch's default thread pool in each of them oversubscribes
    the cores (20 times slower with 6 workers on 8 cores), one thread each
    does not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(hp, rng, lengths=LENGTHS):
    """tests/test_train.py `make_batch`, with unequal lengths."""
    return {
        "phone": rng.standard_normal((B, T, hp.encoder_dim)).astype(
            np.float32),
        "phone_lengths": np.asarray(lengths, np.int32),
        "pitch": rng.integers(1, 255, (B, T)).astype(np.int32),
        "pitchf": rng.uniform(100, 300, (B, T)).astype(np.float32),
        "spec": rng.standard_normal((B, T, hp.data.spec_channels)).astype(
            np.float32),
        "spec_lengths": np.asarray(lengths, np.int32),
        "wave": rng.standard_normal(
            (B, T * hp.data.hop_length, 1)).astype(np.float32) * 0.1,
        "sid": np.zeros((B,), np.int32),
    }


def pinned(batch, rng):
    eps = rng.standard_normal((B, T, HP.model.inter_channels)).astype(
        np.float32)
    return dict(batch, pin_ids_slice=IDS, pin_noise_eps=eps)


def numpy_state(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def jax_trees(state, version="v1"):
    """The port trainer's weights as the JAX trainer's (g_params,
    d_params), carried over the reference layout."""
    m = HP.model
    g = synthesizer_params_from_state_dict(
        numpy_state(state.net_g), n_layers=m.n_layers,
        n_ups=len(m.upsample_rates), num_kernels=len(m.resblock_kernel_sizes),
        use_f0=True, has_enc_q=True, fold_weight_norm=False, strict=True)
    d = discriminator_params_from_state_dict(numpy_state(state.net_d),
                                             version=version)
    return g, d


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def japply(module, variables, *args, **static):
    """module.apply under jax.jit (one XLA compile instead of one per op);
    keyword arguments are static."""
    return jax.jit(functools.partial(module.apply, **static))(variables,
                                                              *args)


def close(got, want, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def jax_steps(g, d, batch):
    """tpu_rvc's jitted step, twice from the trainer's weights on the
    pinned batch, in a process of its own, compiled at XLA's backend
    optimization level 0 (a shorter compile, the same function) -> each
    step's metrics and the weights after step 1 in the port's layout."""
    single_threaded_child()
    jstate, net_g, net_d = jax_create_train_state(
        JAX_HP, jax.random.PRNGKey(0), g_params=g, d_params=d)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    step = make_train_step(net_g, net_d, JAX_HP, donate=False).lower(
        jstate, jbatch, key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    wants, after_1 = [], None
    for i in range(2):
        jstate, want = step(jstate, jbatch, key)
        wants.append(jax.device_get(want))
        if i == 0:
            after_1 = train_state_from_jax(jax.device_get(jstate.g_params),
                                           jax.device_get(jstate.d_params),
                                           "v1")
    return wants, after_1


@pytest.fixture(scope="module")
def world(one_torch_thread):
    """One seeded port trainer, its weights in the JAX trees and one pinned
    batch; tpu_rvc's two steps start at once in a spawned process (the
    step's compile holds the interpreter lock for tens of seconds) and run
    while the module's other tests run here."""
    state = create_train_state(HP, seed=3, device="cpu")
    g, d = jax_trees(state)
    rng = np.random.default_rng(5)
    batch = pinned(make_batch(HP, rng), rng)
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        steps = pool.submit(jax_steps, g, d, batch)
        _, net_g, net_d = jax_create_train_state(
            JAX_HP, jax.random.PRNGKey(0), g_params=g, d_params=d)
        yield dict(state=state, g=g, d=d, batch=batch, net_g=net_g,
                   net_d=net_d, jax_steps=steps)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_posterior_encoder_matches_jax(world):
    m, b = HP.model, world["batch"]
    enc = JaxPosterior(HP.data.spec_channels, m.inter_channels,
                       m.hidden_channels, 5, 1, 16,
                       gin_channels=m.gin_channels, weight_norm=True)
    g = np.random.default_rng(7).standard_normal(
        (B, 1, m.gin_channels)).astype(np.float32)
    want = japply(enc, {"params": world["g"]["enc_q"]}, b["spec"],
                  b["spec_lengths"], g, None, b["pin_noise_eps"])
    with torch.no_grad():
        got = world["state"].net_g.enc_q(
            t(b["spec"]), t(b["spec_lengths"]), g=t(g).transpose(1, 2),
            eps=t(b["pin_noise_eps"]))
    for name, x, y in zip(("z", "m", "logs", "mask"), got, want):
        close(x, y, what=name)


def test_flow_forward_matches_jax(world):
    m = HP.model
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, m.inter_channels)).astype(np.float32)
    mask = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(
        np.float32)[..., None]
    g = rng.standard_normal((B, 1, m.gin_channels)).astype(np.float32)
    flow = JaxFlow(m.inter_channels, m.hidden_channels, 5, 1, 3,
                   gin_channels=m.gin_channels, weight_norm=True)
    want = japply(flow, {"params": world["g"]["flow"]}, x, mask, g,
                  reverse=False)
    with torch.no_grad():
        got = world["state"].net_g.flow(
            t(x).transpose(1, 2), t(mask).transpose(1, 2),
            g=t(g).transpose(1, 2), reverse=False).transpose(1, 2)
    close(got, want)
    # and the reverse direction undoes it
    with torch.no_grad():
        back = world["state"].net_g.flow(
            got.transpose(1, 2), t(mask).transpose(1, 2),
            g=t(g).transpose(1, 2)).transpose(1, 2)
    close(back, x * mask, atol=1e-5)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_mpd_matches_jax(world, version):
    """Outputs and every feature map of each discriminator."""
    if version == "v1":
        net, d = world["state"].net_d, world["d"]
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(11)
            net = MultiPeriodDiscriminator("v2")
        d = discriminator_params_from_state_dict(numpy_state(net), "v2")
    rng = np.random.default_rng(9)
    y, y_hat = (rng.standard_normal((B, 1000, 1)).astype(np.float32) * 0.3
                for _ in range(2))
    want = japply(JaxMPD(version), {"params": d}, y, y_hat)
    with torch.no_grad():
        got = net(t(y).transpose(1, 2), t(y_hat).transpose(1, 2))
    assert len(got[0]) == len(want[0]) == (9 if version == "v2" else 7)
    for o, w in zip(got[0] + got[1], want[0] + want[1]):
        close(o, w, what="output")
    for fo, fw in zip(got[2] + got[3], want[2] + want[3]):
        for x, y_ in zip(fo, fw):
            # ours (B, C, T') or (B, C, H, p); theirs (B, T', 1, C), (B, H, p, C)
            x = x[..., None] if x.dim() == 3 else x
            close(x.permute(0, 2, 3, 1), y_, what=f"fmap {tuple(x.shape)}")


def test_synthesizer_forward_matches_jax(world):
    """The training forward with the slice and the posterior draw pinned:
    waveform to 1e-4, every latent to atol 1e-5 / rtol 1e-4."""
    b = world["batch"]
    want = japply(world["net_g"], {"params": world["g"]}, b["phone"],
                  b["phone_lengths"], b["spec"], b["spec_lengths"], b["sid"],
                  b["pitch"], b["pitchf"], IDS, b["pin_noise_eps"],
                  deterministic=True)
    with torch.no_grad():
        got = world["state"].net_g(
            t(b["phone"]), t(b["phone_lengths"]), t(b["spec"]),
            t(b["spec_lengths"]), t(b["sid"]), t(b["pitch"]), t(b["pitchf"]),
            ids_slice=t(IDS), noise_eps=t(b["pin_noise_eps"]),
            deterministic=True)
    close(got[0], want[0], rtol=0, atol=1e-4, what="audio")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name, x, y in zip(("x_mask", "y_mask"), got[2:4], want[2:4]):
        close(x, y, what=name)
    for name, x, y in zip(("z", "z_p", "m_p", "logs_p", "m_q", "logs_q"),
                          got[4], want[4]):
        close(x, y, what=name)


def test_training_spectrogram_and_mel_match_jax():
    """`spectrogram`, `spec_to_mel`, `mel_spectrogram` at the TINY_HP
    shapes (reference padding, sqrt(|X|^2 + 1e-6)), and the gradient is
    finite through a signal of zeros."""
    d = HP.data
    y = np.random.default_rng(12).standard_normal((2, 1600)).astype(
        np.float32) * 0.3
    y[1, 400:900] = 0.0
    spec = mel.spectrogram(t(y), d.filter_length, d.hop_length, d.win_length)
    close(spec, jax_mel.spectrogram(jnp.asarray(y), d.filter_length,
                                    d.hop_length, d.win_length))
    args = (d.filter_length, d.n_mel_channels, d.sampling_rate)
    close(mel.spec_to_mel(spec, *args),
          jax_mel.spec_to_mel(jnp.asarray(spec.numpy()), *args))
    close(mel.mel_spectrogram(t(y), *args, d.hop_length, d.win_length),
          jax_mel.mel_spectrogram(jnp.asarray(y), *args, d.hop_length,
                                  d.win_length))
    zeros = torch.zeros(1, 1600, requires_grad=True)
    mel.mel_spectrogram(zeros, *args, d.hop_length, d.win_length).sum(
    ).backward()
    assert bool(torch.isfinite(zeros.grad).all())


def test_losses_match_jax():
    rng = np.random.default_rng(10)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dr, dg = [arr(2, 10), arr(2, 7)], [arr(2, 10), arr(2, 7)]
    fr = [[arr(2, 4, 4), arr(2, 3)], [arr(2, 3, 3)]]
    fg = [[arr(2, 4, 4), arr(2, 3)], [arr(2, 3, 3)]]
    pairs = [
        (losses.discriminator_loss([t(x) for x in dr], [t(x) for x in dg])[0],
         jax_losses.discriminator_loss(dr, dg)[0]),
        (losses.generator_loss([t(x) for x in dg])[0],
         jax_losses.generator_loss(dg)[0]),
        (losses.feature_loss([[t(x) for x in f] for f in fr],
                             [[t(x) for x in f] for f in fg]),
         jax_losses.feature_loss(fr, fg))]
    z_p, logs_q, m_p = arr(2, 10, 8), arr(2, 10, 8) * 0.1, arr(2, 10, 8)
    logs_p = arr(2, 10, 8) * 0.1
    mask = (np.arange(10)[None, :, None] < np.array([10, 6])[:, None, None]
            ).astype(np.float32)
    pairs.append((losses.kl_loss(*(t(x) for x in (z_p, logs_q, m_p, logs_p,
                                                   mask))),
                  jax_losses.kl_loss(z_p, logs_q, m_p, logs_p, mask)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

TERMS = ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_kl",
         "loss_gen_all", "grad_norm_g", "grad_norm_d")


def test_train_state_from_jax_inverts_the_jax_conversion(world):
    g_sd, d_sd = train_state_from_jax(world["g"], world["d"], "v1")
    for net, ref in ((world["state"].net_g, g_sd),
                     (world["state"].net_d, d_sd)):
        own = net.state_dict()
        assert set(own) == set(ref)
        for k in own:
            torch.testing.assert_close(ref[k], own[k], rtol=0, atol=0)


def test_f0less_variant_takes_a_step():
    state = create_train_state(HP, seed=1, use_f0=False, device="cpu")
    assert not state.net_g.use_f0
    batch = {k: v for k, v in make_batch(HP, np.random.default_rng(0)).items()
             if k not in ("pitch", "pitchf")}
    m = state.train_step(batch)
    assert state.step == 1
    assert np.isfinite(float(m["loss_gen_all"]))
    assert np.isfinite(float(m["loss_disc"]))


def test_gradient_reaches_attention_and_every_resblock(world):
    net = make_synthesizer(HP, device="cpu", seed=4, train=True)
    b = world["batch"]
    o, *_, (z, z_p, m_p, logs_p, m_q, logs_q) = net(
        t(b["phone"]), t(b["phone_lengths"]), t(b["spec"]),
        t(b["spec_lengths"]), t(b["sid"]), t(b["pitch"]), t(b["pitchf"]))
    (o.square().mean() + m_p.square().mean()).backward()
    for layer in net.enc_p.encoder.attn_layers:
        for p in (layer.conv_q.weight, layer.emb_rel_k, layer.emb_rel_v):
            assert float(p.grad.abs().max()) > 0
    for rb in net.dec.resblocks:
        for conv in list(rb.convs1) + list(rb.convs2):
            assert float(conv.weight_v.grad.abs().max()) > 0


def test_kernels_refuse_inputs_that_require_grad():
    rng = np.random.default_rng(0)
    q, k, v = (t(rng.standard_normal((2, 16, 32)).astype(np.float32))
               for _ in range(3))
    ek, ev = (t(rng.standard_normal((21, 32)).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([16, 11], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        banded_rel_attention(q.requires_grad_(), k, v, ek, ev, lens)
    with torch.no_grad():
        banded_rel_attention(q, k, v, ek, ev, lens)
    sw = pack_stage((3,), (1, 3, 5),
                    [[torch.randn(3, 16, 16) * 0.05 for _ in range(6)]],
                    [[torch.zeros(16) for _ in range(6)]])
    x = torch.randn(16, 40, requires_grad=True)
    for fn in (fused_stage, fused_resblock):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x, sw)
    fused_resblock(x.detach(), sw)


def narrow_v2_48k():
    hp = config.hparams_for("v2", 48000)
    return dataclasses.replace(hp, model=dataclasses.replace(
        hp.model, inter_channels=32, hidden_channels=32, filter_channels=64,
        n_layers=1))


def infer_inputs(hp, T=20, seed=0):
    rng = np.random.default_rng(seed)
    return (t(rng.standard_normal((1, T, hp.encoder_dim)).astype(np.float32)),
            torch.tensor([T]), torch.tensor([0]),
            t(rng.integers(1, 255, (1, T))),
            t(rng.uniform(100, 300, (1, T)).astype(np.float32)))


def test_stage_cache_follows_in_place_updates():
    """infer, scale the resblocks' parameters in place, infer again: the
    result equals a fresh model given the same state_dict, bit for bit
    (the cache once kept views of the biases and copies of the weights)."""
    hp = narrow_v2_48k()
    net = make_synthesizer(hp, device="cpu", seed=2)
    args = infer_inputs(hp)
    net.infer(*args, deterministic=True)
    with torch.no_grad():
        for p in net.dec.resblocks.parameters():
            p.mul_(3.0)
    got = net.infer(*args, deterministic=True)
    fresh = make_synthesizer(hp, device="cpu", seed=9)
    fresh.load_state_dict(net.state_dict())
    assert torch.equal(got, fresh.infer(*args, deterministic=True))


def test_trained_generator_equals_its_small_model(tmp_path):
    """A train-layout G, stepped by the optimizer after an `infer` filled
    its stage cache, against the small model it exports (its weights made
    fp16-exact first, since the file holds fp16)."""
    from tpu_rvc_torch.ckpt.small_model import save_small_model

    hp = dataclasses.replace(narrow_v2_48k(), version="v1", train=dataclasses
                             .replace(HP.train, segment_size=4800))
    state = create_train_state(hp, seed=6, device="cpu")
    args = infer_inputs(hp, T=20, seed=1)
    state.net_g.infer(*args, deterministic=True)
    state.train_step(make_batch(hp, np.random.default_rng(2), [T, T]))
    with torch.no_grad():
        for p in state.net_g.parameters():
            p.copy_(p.half().float())
    path = save_small_model(state.net_g.state_dict(), "48k", 1, "m", 1,
                            hp.version, hp,
                            out_path=os.path.join(tmp_path, "m.pth"))
    loaded, meta = load_synthesizer(path, "cpu")
    assert meta["version"] == "v1" and not hasattr(loaded, "enc_q")
    want = loaded.infer(*args, deterministic=True)
    got = state.net_g.infer(*args, deterministic=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_trainer_entry_points_default_to_cuda(tmp_path):
    """Without a device argument the trainer's entry points mean CUDA and
    raise on a machine without it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tpu_rvc_torch.apps.train import main
    from tpu_rvc_torch.train.extract import extract_f0, extract_features
    from tpu_rvc_torch.train.loop import run_training
    (tmp_path / "1_16k_wavs").mkdir()
    for call in (lambda: create_train_state(HP),
                 lambda: run_training(str(tmp_path), HP),
                 lambda: extract_f0(str(tmp_path), "pm"),
                 lambda: extract_features(str(tmp_path), hubert_path="random"),
                 lambda: main(["train", "--exp-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# two steps against tpu_rvc's, last in the module: the JAX side compiles in
# its spawned process while the tests above run
# ---------------------------------------------------------------------------


def test_train_step_matches_jax(world):
    """Two pinned D-then-G steps against tpu_rvc's jitted step: every loss
    term and both grad norms within 1e-3 relative at both steps; after
    step 1 every parameter within 2 lr of the JAX one (Adam's first update
    is +-lr an element, so a sign that flips on a near-zero gradient costs
    2 lr), under 0.1% of them off by more than 1e-6."""
    # a fresh trainer on the fixture's weights: the fixture's stays as it is
    state = create_train_state(HP, device="cpu",
                               g_state=world["state"].net_g.state_dict(),
                               d_state=world["state"].net_d.state_dict())
    b = world["batch"]
    wants, after_1 = world["jax_steps"].result()
    lr = HP.train.learning_rate
    for i, want in enumerate(wants):
        got = state.train_step(b)
        for k in TERMS:
            w, g = float(want[k]), float(got[k])
            assert abs(g - w) <= 1e-3 * abs(w), f"step {i + 1} {k}: {g} vs {w}"
        close(got["mel_org"], want["mel_org"], what="mel_org")
        if i == 0:
            for net, ref in zip((state.net_g, state.net_d), after_1):
                own = net.state_dict()
                assert set(own) == set(ref)
                diff = torch.cat([(own[k] - ref[k]).abs().flatten()
                                  for k in own])
                assert float(diff.max()) <= 2 * lr * 1.01, float(diff.max())
                assert float((diff > 1e-6).float().mean()) < 1e-3
    assert state.step == 2


def test_deterministic_step_is_reproducible_and_matches_jax(world):
    """The step under `TrainState.deterministic` (`core/device.py`
    `deterministic_math`): two fresh trainers on the fixture's weights take
    the same two pinned steps bit for bit, each step's loss terms and grad
    norms within 1e-3 relative of tpu_rvc's, and the caller's flags come
    back after each step."""
    flags = lambda: (torch.are_deterministic_algorithms_enabled(),  # noqa
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.utils.deterministic.fill_uninitialized_memory)
    before = flags()
    b = world["batch"]
    wants, _ = world["jax_steps"].result()
    runs = []
    for _ in range(2):
        state = create_train_state(HP, device="cpu",
                                   g_state=world["state"].net_g.state_dict(),
                                   d_state=world["state"].net_d.state_dict())
        state.deterministic = True
        for want in wants:
            got = state.train_step(b)
            assert flags() == before
            for k in TERMS:
                w, g = float(want[k]), float(got[k])
                assert abs(g - w) <= 1e-3 * abs(w), f"{k}: {g} vs {w}"
        runs.append({**{"g." + k: v for k, v in
                        state.net_g.state_dict().items()},
                     **{"d." + k: v for k, v in
                        state.net_d.state_dict().items()}})
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
