"""tpu_rvc_torch's CUDA kernels against their plain twins, on the card.

Skipped without a CUDA card.  This file imports no JAX, so on a machine
without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from tpu_rvc_torch.core.device import fp32_math
from tpu_rvc_torch.ops.kernels import (banded_rel_attention,
                                       banded_rel_attention_plain, bigru,
                                       bigru_plain, fused_resblock,
                                       fused_stage, launch_counts,
                                       reset_launch_counts, stage_plain)

from _torch_inputs import (W, attn_inputs, gru_inputs, stage_inputs,
                           stage_weights)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    with fp32_math():
        yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1598, 77])
def test_rel_attention_kernel_matches_plain(rng, cuda, T):
    """rtol/atol 1e-4 (3xTF32, fp32 sums in another order)."""
    q, k, v, ek, ev, lens = attn_inputs(rng, 4, T, 96, [T, T - 13, T // 2, 5])
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    reset_launch_counts()
    got = banded_rel_attention(*args, W)
    assert launch_counts["banded_rel_attention"] == 1
    want = banded_rel_attention_plain(*args, W)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dk,T,lengths", [
    (96, 300, [40, 17, 5, 1]),      # every length inside the first key tile
    (64, 200, [200, 129, 64, 63]),  # dk = 64; lengths at a tile's edge
    (128, 130, [130, 7, 65, 128]),
    (32, 65, [65, 64, 1, 33])])
def test_rel_attention_kernel_short_lengths_and_head_widths(rng, cuda, dk, T,
                                                            lengths):
    """rtol/atol 1e-4.  Keys at or beyond a length are set to -1e4, not
    skipped, whichever 64-key tile and 32-key group they fall in."""
    q, k, v, ek, ev, lens = attn_inputs(rng, 4, T, dk, lengths)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    reset_launch_counts()
    got = banded_rel_attention(*args, W)
    assert launch_counts["banded_rel_attention"] == 1
    torch.testing.assert_close(got, banded_rel_attention_plain(*args, W),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,ks", [(256, 1000, (3, 7, 11)),
                                    (32, 5000, (3, 7, 11)),
                                    (16, 900, (3, 7, 11)),
                                    (64, 50, (3, 7, 11)), (64, 3000, (7,))])
def test_stage_kernel_matches_plain(rng, cuda, C, T, ks):
    """rtol 1e-3, atol 1e-4: 18 chained convs, 3xTF32 with fp32 sums in
    another order than cuDNN's.  C = 16 is the v1 presets' last stage."""
    x, ws, bs = stage_inputs(rng, C, T, ks)
    sw = stage_weights(ws, bs, ks, cuda)
    xt = torch.from_numpy(x.T.copy()).to(cuda)
    name = "fused_resblock" if len(ks) == 1 else "fused_stage"
    reset_launch_counts()
    got = (fused_resblock if len(ks) == 1 else fused_stage)(xt, sw)
    assert launch_counts[name] == 6 * len(ks)
    torch.testing.assert_close(got, stage_plain(xt, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T", [
    (256, 127), (256, 128), (256, 129),      # one 128-step tile -1, 0, +1
    (128, 127), (128, 129), (64, 255), (64, 257), (32, 255), (32, 256),
    (32, 257),                               # one 256-step tile -1, 0, +1
    (256, 4794), (128, 9588), (64, 19176),   # the main path's widths at
    (32, 38352),                             # reduced T, all multiples of 4
    (64, 70000),   # 274 tiles: more than two blocks per SM, whole and half
    (32, 70001)])  # tiles, and an odd T on the 4-byte staging path
def test_stage_kernel_tile_edges_and_main_path_widths(rng, cuda, C, T):
    """rtol 1e-3, atol 1e-4, the stock three resblocks; 18 launches."""
    ks = (3, 7, 11)
    x, ws, bs = stage_inputs(rng, C, T, ks)
    sw = stage_weights(ws, bs, ks, cuda)
    xt = torch.from_numpy(x.T.copy()).to(cuda)
    reset_launch_counts()
    got = fused_stage(xt, sw)
    assert launch_counts["fused_stage"] == 18
    torch.testing.assert_close(got, stage_plain(xt, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,ks", [
    (16, 5110, (3, 7, 11)), (16, 5110, (7,)),   # v1's fifth level, 10 frames
    (16, 2321, (3, 7, 11)), (16, 2321, (7,)),   # C = 16, T % 4 == 1
    (256, 290, (3, 7, 11)), (256, 290, (7,)),   # a 10x first level, 29
    (128, 1162, (3, 7, 11))])                   # frames; T % 4 == 2
def test_stage_kernel_family_widths_and_unaligned_t(rng, cuda, C, T, ks):
    """The C = 16 build and the scalar staging path (T % 4 != 0) that the
    v1/32k and v1/48k decoders and the 10x first levels of a streaming
    block reach, K2 and K3: rtol 1e-3, atol 1e-4."""
    x, ws, bs = stage_inputs(rng, C, T, ks)
    sw = stage_weights(ws, bs, ks, cuda)
    xt = torch.from_numpy(x.T.copy()).to(cuda)
    name = "fused_resblock" if len(ks) == 1 else "fused_stage"
    reset_launch_counts()
    got = (fused_resblock if len(ks) == 1 else fused_stage)(xt, sw)
    assert launch_counts[name] == 6 * len(ks)
    torch.testing.assert_close(got, stage_plain(xt, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(rng, cuda):
    q, k, v, ek, ev, lens = attn_inputs(rng, 2, 40, 96, [40, 30])
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    with pytest.raises(ValueError, match="lengths must be"):
        banded_rel_attention(*args[:5], args[5].long(), W)
    with pytest.raises(ValueError, match="contiguous"):
        banded_rel_attention(args[0].transpose(1, 2).contiguous()
                             .transpose(1, 2), *args[1:], W)
    x, ws, bs = stage_inputs(rng, 24, 100, (3,))
    with pytest.raises(ValueError, match="one of"):
        banded_rel_attention(*[a[..., :40].contiguous() for a in args[:5]],
                             args[5], W)
    with pytest.raises(ValueError, match="must be one of"):
        fused_resblock(torch.from_numpy(x.T.copy()).to(cuda),
                       stage_weights(ws, bs, (3,), cuda))


# ---------------------------------------------------------------------------
# the shapes one streaming block gives the kernels (48 kHz, 0.25 s blocks,
# 2.5 s of context: a 281-frame window, a 30-frame tail), and shorter ones
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("C,T", [
    (256, 360), (128, 3600), (64, 7200), (32, 14400),  # a 30-frame tail
    (256, 104), (32, 104),    # less than one 128-step tile
    (256, 7), (32, 7),        # shorter than any kernel's reach
    (256, 408), (128, 4080),  # a tail of 34 frames: a formant shift's
    (64, 361), (32, 14399)])  # T not a multiple of 4 or 8
def test_stage_kernel_streaming_shapes_and_short_t(rng, cuda, C, T):
    """rtol 1e-3, atol 1e-4, the stock three resblocks; 18 launches.  The
    tiles outnumber neither the SMs nor, at the shortest, one block."""
    ks = (3, 7, 11)
    x, ws, bs = stage_inputs(rng, C, T, ks)
    sw = stage_weights(ws, bs, ks, cuda)
    xt = torch.from_numpy(x.T.copy()).to(cuda)
    reset_launch_counts()
    got = fused_stage(xt, sw)
    assert launch_counts["fused_stage"] == 18
    torch.testing.assert_close(got, stage_plain(xt, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [7200, 104, 7])
def test_resblock_kernel_streaming_shapes_and_short_t(rng, cuda, T):
    """K3 (one k = 7 resblock) at C = 64: rtol 1e-3, atol 1e-4."""
    x, ws, bs = stage_inputs(rng, 64, T, (7,))
    sw = stage_weights(ws, bs, (7,), cuda)
    xt = torch.from_numpy(x.T.copy()).to(cuda)
    reset_launch_counts()
    got = fused_resblock(xt, sw)
    assert launch_counts["fused_resblock"] == 6
    torch.testing.assert_close(got, stage_plain(xt, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[281, 281], [281, 250]])
def test_rel_attention_kernel_streaming_window(rng, cuda, lengths):
    """K1 at (2, 281, 96): T a multiple of neither the 32-row query tile
    nor the 64-key tile.  rtol/atol 1e-4."""
    q, k, v, ek, ev, lens = attn_inputs(rng, 2, 281, 96, lengths)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    reset_launch_counts()
    got = banded_rel_attention(*args, W)
    assert launch_counts["banded_rel_attention"] == 1
    torch.testing.assert_close(got, banded_rel_attention_plain(*args, W),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the stream axis of the stage kernel: (N, C, T), what the serving path
# gives it
# ---------------------------------------------------------------------------


def batched_stage_inputs(rng, N, C, T, ks, device):
    """N streams of similar audio (a common part plus a tenth of their
    own): a halo row read from a neighbouring stream would be a small
    error, which bit-for-bit equality still sees."""
    x, ws, bs = stage_inputs(rng, C, T, ks)
    own = rng.standard_normal((N, C, T)).astype(np.float32) * 0.03
    xb = torch.from_numpy(x.T[None] + own).to(device).contiguous()
    return xb, stage_weights(ws, bs, ks, device)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 8])
@pytest.mark.parametrize("C,T", [
    (256, 360), (128, 3600), (64, 7200), (32, 14400),  # a 30-frame tail
    (256, 7), (64, 104), (128, 1000),
    (256, 361), (32, 1001), (64, 7),   # odd T: a stream's base is not
    (16, 333),                         # 16-byte aligned
    (256, 127), (256, 129), (64, 255), (64, 257), (32, 256)])  # tile edges
def test_stage_kernel_stream_axis(rng, cuda, N, C, T):
    """K2 on (N, C, T): against the batched plain twin (rtol 1e-3, atol
    1e-4), and bit for bit against the same kernel launched stream by
    stream (same tiles, same order of sums); 18 launches whatever N."""
    ks = (3, 7, 11)
    xb, sw = batched_stage_inputs(rng, N, C, T, ks, cuda)
    reset_launch_counts()
    got = fused_stage(xb, sw)
    assert launch_counts["fused_stage"] == 18
    assert got.shape == (N, C, T)
    torch.testing.assert_close(got, stage_plain(xb, sw), rtol=1e-3,
                               atol=1e-4)
    one_by_one = torch.stack([fused_stage(xb[n], sw) for n in range(N)])
    assert torch.equal(got, one_by_one)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T", [(1, 7200), (2, 7201), (8, 7200), (8, 104),
                                 (8, 7)])
def test_resblock_kernel_stream_axis(rng, cuda, N, T):
    """K3 (one k = 7 resblock, C = 64) on (N, 64, T): 6 launches."""
    xb, sw = batched_stage_inputs(rng, N, 64, T, (7,), cuda)
    reset_launch_counts()
    got = fused_resblock(xb, sw)
    assert launch_counts["fused_resblock"] == 6
    torch.testing.assert_close(got, stage_plain(xb, sw), rtol=1e-3,
                               atol=1e-4)
    one_by_one = torch.stack([fused_resblock(xb[n], sw) for n in range(N)])
    assert torch.equal(got, one_by_one)


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_card(rng, cuda):
    """With the first card current, each wrapper launches on the card its
    tensors lie on (the second) and leaves the first current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    q, k, v, ek, ev, lens = attn_inputs(rng, 4, 77, 96, [77, 64, 5, 1])
    args = [torch.from_numpy(a).to(other) for a in (q, k, v, ek, ev, lens)]
    xb, sw = batched_stage_inputs(rng, 2, 64, 7200, (7,), other)
    with torch.cuda.device(0):
        got_attn = banded_rel_attention(*args, W)
        got_rb = fused_resblock(xb, sw)
        assert torch.cuda.current_device() == 0
    torch.testing.assert_close(got_attn, banded_rel_attention_plain(*args, W),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_rb, stage_plain(xb, sw), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[281] * 16,
                                     [281, 281, 250, 250, 17, 17, 1, 1] * 2])
def test_rel_attention_kernel_sixteen_rows(rng, cuda, lengths):
    """K1 at (16, 281, 96), eight streams of two heads: equal lengths (the
    serving tick) and unequal ones (an offline batch).  rtol/atol 1e-4."""
    q, k, v, ek, ev, lens = attn_inputs(rng, 16, 281, 96, lengths)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev, lens)]
    reset_launch_counts()
    got = banded_rel_attention(*args, W)
    assert launch_counts["banded_rel_attention"] == 1
    torch.testing.assert_close(got, banded_rel_attention_plain(*args, W),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# RMVPE's BiGRU (csrc/bigru.cu): offline B = 1 up to a 56 s bucket, serving's
# 32 rows of 32 frames, and 4 rows of a 79 s bucket
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 1), (1, 32), (1, 5600), (3, 1), (3, 32),
                                 (3, 5600), (32, 1), (32, 32), (32, 5600),
                                 (4, 7904)])
def test_bigru_kernel_matches_plain_and_cudnn(rng, cuda, B, T):
    """The kernel against the plain twin and against cuDNN's `nn.GRU`
    (TF32 off), atol 2e-5 (outputs in (-1, 1)): fp32 FMA with the sums in
    another order, over up to 7904 steps; one launch."""
    gru, x = gru_inputs(rng, B, T, cuda)
    with torch.no_grad():
        reset_launch_counts()
        got = bigru(x, gru)
        assert launch_counts["bigru"] == 1
        want = bigru_plain(x, gru)
        cudnn = gru(x)[0]
    assert got.shape == (B, T, 512)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got, cudnn, rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(32, 32), (17, 100), (9, 3)])
def test_bigru_rows_do_not_depend_on_the_split(rng, cuda, B, T):
    """However many rows a cluster takes (8, 4 or 2 for these B on an
    H100), the kernel gives each row the bits of that row launched alone,
    from the same gates (the projection's product may sum in another
    order at another row count)."""
    from tpu_rvc_torch.ops.kernels.bigru import _kernel, _params, _projection

    gru, x = gru_inputs(rng, B, T, cuda)
    stream = torch.cuda.current_stream().cuda_stream
    weights = [p.data_ptr() for p in _params(gru)[4:]]
    with torch.no_grad():
        gi = _projection(x, gru)
        got = torch.empty(B, T, 512, device=cuda)
        assert _kernel()(gi.data_ptr(), *weights, got.data_ptr(), B, T,
                         stream) == 0
        alone = torch.empty_like(got)
        for b in range(B):
            assert _kernel()(gi[b].data_ptr(), *weights, alone[b].data_ptr(),
                             1, T, stream) == 0
    assert torch.equal(got, alone)


@pytest.mark.cuda
def test_bigru_one_launch_per_e2e_call(cuda):
    """RMVPE's E2E on the card launches the kernel once a call, for one
    row and for a batch, and never cuDNN's RNN."""
    from tpu_rvc_torch.models.rmvpe import E2E

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        on_cpu = E2E(n_blocks=1, n_gru=1, en_de_layers=2, inter_layers=1,
                     en_out_channels=4).eval()
    e2e = copy.deepcopy(on_cpu).to(cuda)
    calls = []
    real = torch._VF.gru
    torch._VF.gru = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with torch.no_grad():
            for B in (1, 4):
                mel = torch.randn(B, 128, 64)
                reset_launch_counts()
                out = e2e(mel.to(cuda))
                assert launch_counts["bigru"] == 1
                torch.testing.assert_close(out.cpu(), on_cpu(mel), rtol=0,
                                           atol=1e-4)
    finally:
        torch._VF.gru = real
    assert not calls


@pytest.mark.cuda
def test_bigru_launches_on_the_inputs_card_and_stream(rng, cuda):
    """With the first card current, the kernel runs on the card its input
    lies on (the last), and on that card's current stream: held behind a
    sleep there, the launch waits for it, the default stream stays idle,
    and the result is right once the side stream is done."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    gru, x = gru_inputs(rng, 2, 300, dev)
    side = torch.cuda.Stream(dev)
    with torch.no_grad():
        bigru(x, gru)                        # the build, outside the test
        want = bigru_plain(x, gru)
        torch.cuda.synchronize(dev)
        with torch.cuda.device(0):
            with torch.cuda.stream(side):
                torch.cuda._sleep(200_000_000)
                got = bigru(x, gru)
            assert torch.cuda.current_device() == 0
        assert not side.query()
        assert torch.cuda.default_stream(dev).query()
        side.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_bigru_ignores_autocast(rng, cuda):
    """Under bf16 autocast the wrapper gives the fp32 answer: its
    projection's product stays fp32, the buffer the kernel reads."""
    gru, x = gru_inputs(rng, 3, 40, cuda)
    with torch.no_grad():
        want = bigru(x, gru)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = bigru(x, gru)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.cuda
def test_bigru_rejects_what_the_kernel_does_not_take(rng, cuda):
    gru, x = gru_inputs(rng, 2, 10, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="float32"):
            bigru(x.double(), gru)
        with pytest.raises(ValueError, match="float32"):
            bigru(x[..., :200], gru)
        with pytest.raises(ValueError, match="float32"):
            bigru(x[:, :0], gru)
        with pytest.raises(ValueError, match="parameters must be"):
            bigru(x, gru.double())
        with pytest.raises(ValueError, match="parameters must be"):
            bigru(x, gru.float().cpu())
        narrow = torch.nn.GRU(384, 128, batch_first=True,
                              bidirectional=True).to(cuda)
        with pytest.raises(ValueError, match="hidden size 256"):
            bigru(x, narrow)
        one_way = torch.nn.GRU(384, 256, batch_first=True).to(cuda)
        with pytest.raises(ValueError, match="bidirectional"):
            bigru(x, one_way)
        two_layers = torch.nn.GRU(384, 256, num_layers=2, batch_first=True,
                                  bidirectional=True).to(cuda)
        with pytest.raises(ValueError, match="one-layer"):
            bigru(x, two_layers)


def small_stream_engine(device, **kw):
    """A narrow synthesizer whose decoder stages are widths the kernels
    are built for (64 and 32), a small HuBERT and a tiny RMVPE."""
    from tpu_rvc_torch.f0.rmvpe import RMVPE
    from tpu_rvc_torch.models.hubert import Hubert
    from tpu_rvc_torch.models.rmvpe import E2E
    from tpu_rvc_torch.models.synthesizer import Synthesizer
    from tpu_rvc_torch.pipeline.rt import RealtimeVC

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        synth = Synthesizer(
            spec_channels=129, segment_size=640, inter_channels=32,
            hidden_channels=64, filter_channels=64, n_heads=2, n_layers=1,
            kernel_size=3, p_dropout=0.0, resblock="1",
            resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=(
                (1, 3, 5), (1, 3, 5)), upsample_rates=(10, 16),
            upsample_initial_channel=128, upsample_kernel_sizes=(20, 32),
            spk_embed_dim=2, gin_channels=16, sr=16000, encoder_dim=64,
            use_f0=True).eval()
        for up in synth.dec.ups:       # see chip_smoke.py write_model
            up.weight.data.mul_(8.0)
        hubert = Hubert(output_layer=1, final_proj=False, embed=64,
                        ffn_dim=64, n_heads=2, pos_conv_k=16,
                        pos_conv_groups=2, conv_layers=(
                            (32, 10, 5), (32, 4, 4), (32, 4, 4), (32, 2, 2),
                            (32, 2, 2))).eval()
        e2e = E2E(n_blocks=1, n_gru=1, en_de_layers=2, inter_layers=1,
                  en_out_channels=4).eval()
    eng = RealtimeVC(hubert=hubert, synth=synth, noise_scale=0.0,
                     deterministic=True, device=device, **kw)
    eng.f0_gen._estimators["rmvpe"] = RMVPE(model=e2e, device=device)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("f0method", ["pm", "rmvpe"])
def test_stream_session_on_the_card(cuda, f0method):
    """A small deterministic stream on the card: the fused block queues
    its work without one host wait between upload and fetch (PyTorch's
    sync debug mode set to "error" around it), launches both kernels, and
    agrees with the host path on the card (1e-4 of full scale) and with
    the fused path on the CPU (relative L2 1e-3), formant shift included
    on the host path (a decoder tail of any length)."""
    from tpu_rvc_torch.pipeline.rt import StreamSession

    sr, n_blocks = 16000, 5
    t = np.arange(int(sr * 0.16) * n_blocks) / sr
    ph = 2 * np.pi * np.cumsum(200 + 50 * np.sin(2 * np.pi * 0.8 * t)) / sr
    audio = (0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)).astype(np.float32)
    kw = dict(samplerate=sr, block_time=0.16, crossfade_time=0.04,
              extra_time=0.5, f0method=f0method, protect=0.33)

    def run(device, fused, guard=False):
        sess = StreamSession(small_stream_engine(device), fused=fused, **kw)
        outs = []
        for i in range(n_blocks):
            if guard and i == 1:  # block 0 uploads the constants
                inner = sess._fused._block

                def guarded(*a, inner=inner):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return inner(*a)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                sess._fused._block = guarded
            outs.append(sess.feed(
                audio[i * sess.block_frame: (i + 1) * sess.block_frame]))
        return np.concatenate(outs), sess

    reset_launch_counts()
    fused, sess = run("cuda", True, guard=True)
    assert launch_counts["banded_rel_attention"] == n_blocks
    assert launch_counts["fused_stage"] == n_blocks * 2 * 12
    assert sess._fused_state["wav16"].is_cuda
    assert np.isfinite(fused).all() and np.abs(fused).max() > 1e-3
    host, sess = run("cuda", False)
    assert np.abs(fused - host).max() < 1e-4
    cpu, _ = run("cpu", True)
    assert np.linalg.norm(fused - cpu) / np.linalg.norm(cpu) < 1e-3
    sess.set_formant(1.5)
    out = sess.feed(audio[: sess.block_frame])
    assert out.shape == (sess.block_frame,) and np.isfinite(out).all()


@pytest.mark.cuda
def test_train_kmeans_on_the_card(cuda):
    """Centroids on the card against the CPU's, same draws: rtol 1e-4."""
    from tpu_rvc_torch.retrieval.index import train_kmeans

    rng = np.random.default_rng(0)
    centres = rng.standard_normal((40, 32)) * 4
    x = (centres[rng.integers(0, 40, 2000)]
         + 0.3 * rng.standard_normal((2000, 32))).astype(np.float32)
    np.testing.assert_allclose(train_kmeans(x, 64, 3, 512, 0, device="cuda"),
                               train_kmeans(x, 64, 3, 512, 0, device="cpu"),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# multi-stream serving on the card
# ---------------------------------------------------------------------------


def small_voice(n, f0, sr=16000):
    t = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(f0 + 50 * np.sin(2 * np.pi * 0.8 * t)) / sr
    return (0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)).astype(np.float32)


def run_scheduler(device, pipelined, n_blocks=5, guard=False, n_slots=2):
    """Two clients through a small scheduler in lockstep -> per slot the
    pieces collected after each tick and after flush()."""
    from tpu_rvc_torch.pipeline.serve import SlotScheduler

    sched = SlotScheduler(small_stream_engine(device), n_slots,
                          samplerate=16000, block_time=0.16,
                          crossfade_time=0.04, extra_time=0.5, f0method="pm",
                          protect=0.33, clock=lambda: 0.0,
                          pipelined=pipelined)
    bf = sched.block_frame
    audios = [small_voice(n_blocks * bf, 180.0 + 70 * s)
              for s in range(n_slots)]
    slots = [sched.attach() for _ in audios]
    got = [[] for _ in slots]
    for i in range(n_blocks):
        if guard and i == 1:  # tick 0 uploads the constants
            inner = sched.fused._block

            def guarded(*a, inner=inner):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return inner(*a)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            sched.fused._block = guarded
        for slot, audio in zip(slots, audios):
            sched.submit(slot, audio[i * bf:(i + 1) * bf])
        sched.tick()
        for s, slot in enumerate(slots):
            got[s].append(sched.collect(slot))
    sched.flush()
    for s, slot in enumerate(slots):
        got[s].append(sched.collect(slot))
    return got, sched


@pytest.mark.cuda
def test_scheduler_on_the_card(cuda):
    """A 2-slot scheduler on the card: every tick after the first queues
    its batched block without one host wait between upload and fetch
    (PyTorch's sync debug mode set to "error" around it), launches K1 once
    and K2 24 times a tick whatever the number of streams, keeps its state
    on the card, and agrees with the scheduler on the CPU (relative L2
    1e-3)."""
    reset_launch_counts()
    got, sched = run_scheduler("cuda", False, guard=True)
    assert launch_counts["banded_rel_attention"] == 5
    assert launch_counts["fused_stage"] == 5 * 2 * 12
    assert sched.state["wav16"].is_cuda
    assert sched.state["wav16"].shape[0] == 2
    cpu, _ = run_scheduler("cpu", False)
    for s in range(2):
        a, b = np.concatenate(got[s]), np.concatenate(cpu[s])
        assert a.shape == b.shape == (5 * sched.block_frame,)
        assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
    assert sched.stats()["underruns"] == [0, 0]


@pytest.mark.cuda
def test_pipelined_scheduler_on_the_card(cuda):
    """pipelined=True on the card (a copy into pinned memory on a side
    stream, an event waited on before delivery), also under the sync debug
    mode: serial mode's streams sample for sample, one tick later.  cuDNN
    is held to its deterministic algorithms for the two runs: its default
    choice for a transposed convolution adds with atomics, and two runs of
    one mode then differ in the last bit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ser, sched = run_scheduler("cuda", False)
        pip, _ = run_scheduler("cuda", True, guard=True)
    finally:
        torch.backends.cudnn.deterministic = saved
    bf = sched.block_frame
    for s in range(2):
        assert [len(x) for x in ser[s]] == [bf] * 5 + [0]
        assert [len(x) for x in pip[s]] == [0] + [bf] * 5
        np.testing.assert_array_equal(np.concatenate(pip[s]),
                                      np.concatenate(ser[s]))


@pytest.mark.cuda
def test_torchgate_on_the_card(cuda):
    """The denoiser on the card against the CPU: atol 1e-5 of full scale
    (fp32 FFTs in another order)."""
    from tpu_rvc_torch.audio.torchgate import TorchGate

    rng = np.random.default_rng(5)
    t = np.arange(16000) / 16000
    x = (0.4 * np.sin(2 * np.pi * 220 * t) * (t > 0.3)
         + 0.02 * rng.standard_normal(16000)).astype(np.float32)
    for kw in (dict(), dict(nonstationary=True)):
        got = TorchGate(16000, n_fft=640, device="cuda", **kw)(x, x[:4000])
        want = TorchGate(16000, n_fft=640, device="cpu", **kw)(x, x[:4000])
        assert np.abs(got - want).max() < 1e-5


@pytest.mark.cuda
def test_convert_long_over_two_cards(cuda):
    """convert_long with its chunk rows over two distinct cards agrees
    with one card within 1 LSB, launches both kernels, and leaves the
    first card current."""
    from tpu_rvc_torch.core.mesh import make_mesh
    from tpu_rvc_torch.parallel import convert_long
    from tpu_rvc_torch.pipeline.vc import Pipeline

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    eng = small_stream_engine("cuda")
    pipe = Pipeline(16000, hubert=eng.hubert, synth=eng.synth,
                    noise_scale=0.0, deterministic=True, device="cuda:0",
                    x_pad=0.5, x_query=1.0, x_center=4.0, x_max=5.0)
    t = np.arange(11 * 16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 0.7 * t))).astype(np.float32)
    one = convert_long(pipe, 0, audio, make_mesh(devices=["cuda:0"]),
                       f0_method="pm")
    reset_launch_counts()
    with torch.cuda.device(0):
        two = convert_long(pipe, 0, audio,
                           make_mesh(devices=["cuda:0", "cuda:1"]),
                           f0_method="pm")
        assert torch.cuda.current_device() == 0
    assert launch_counts["banded_rel_attention"] > 0
    assert launch_counts["fused_stage"] > 0
    assert one.shape == two.shape and np.abs(one).max() > 0
    assert np.abs(one.astype(np.int32) - two).max() <= 1


def full_width_dp_run(tmp_path, world, layout, steps=2):
    """`world` NCCL ranks, one a card, on `layout` ("replicated" or a
    (data, model) mesh) against one process on cuda:0: v2/48k at full
    width, fp32, 4 pinned rows of lengths (200, 163, 200, 110)."""
    import dataclasses
    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.tools.dist_steps import (Ranks, full_params,
                                                make_batch, run_steps)
    from tpu_rvc_torch.train.step import create_train_state

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA cards")
    hp = hparams_for("v2", 48000)
    hp = dataclasses.replace(hp, train=dataclasses.replace(
        hp.train, fp16_run=False))
    batches = [make_batch(hp, (200, 163, 200, 110), 21, 200,
                          pins=(10, 120, 150, 60))] * steps
    ranks = Ranks({"case": "steps", "hp": hp, "seed": 7, "device": "cuda",
                   "timeout_s": 300, "threads": 4, "layouts": [layout],
                   "batches": batches, "snapshots": list(range(1, steps + 1)),
                   "keep": [1], "out": str(tmp_path / "ranks")}, world)
    state = create_train_state(hp, seed=7, device="cuda:0")
    one, _, one_params = run_steps(state, batches, (1,), full_params)
    res = ranks.wait(600)
    for r, rank in enumerate(res):
        lay = rank["layouts"][0]
        for i in range(steps):
            for k, want in one[i].items():
                got = lay["metrics"][i][k]
                assert abs(got - want) <= 1e-4 * abs(want), (r, i, k)
            assert lay["snapshots"][i + 1]["same_as_rank0"]
        assert not any(rank["launches"].values())
    # after one step: on the card two one-process runs already drift apart
    # in more than 0.1% of the elements by the third (PERF.md)
    got = res[0]["layouts"][0]["snapshots"][1]["params"]
    diff = torch.cat([(got[k] - v).abs().flatten()
                      for k, v in one_params[1].items()])
    assert float(diff.max()) <= 2 * hp.train.learning_rate * 1.01
    assert float((diff > 1e-6).float().mean()) < 1e-3
    return res


@pytest.mark.cuda
def test_data_parallel_step_over_two_cards(cuda, tmp_path):
    """Two NCCL ranks, replicated: every loss term and grad norm within
    1e-4 relative of one process on all 4 rows at both steps (cuDNN's
    algorithms differ between 2 and 4 rows), the ranks' parameters
    bit-identical, and after the first step within 2 lr of the one
    process's, under 0.1% of them beyond 1e-6."""
    full_width_dp_run(tmp_path, 2, "replicated")


@pytest.mark.cuda
def test_hsdp_step_over_four_cards(cuda, tmp_path):
    """Four NCCL ranks on a (2, 2) mesh: as the two-card test, and the
    state sharded over "model" before and after the steps."""
    res = full_width_dp_run(tmp_path, 4, (2, 2))
    for rank in res:
        assert min(rank["layouts"][0]["sharded_frac"]) >= 0.5
