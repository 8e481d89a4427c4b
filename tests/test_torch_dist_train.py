"""tpu_rvc_torch's data-parallel and sharded training against tpu_rvc's
(JAX) and against the port's one-process step, on the CPU.

Ranks are processes of `tpu_rvc_torch/tools/dist_steps.py` (no JAX in
them), one thread each, joined over gloo on 127.0.0.1 with a 60 s timeout
and stopped after 180 s, so a hang fails a test.  The step cases run
tests/test_torch_train.py's tiny HP on a global batch of 4 rows of
lengths (24, 19, 24, 13): rank 0 holds rows 0 and 2 (mask sum 48), rank 1
rows 1 and 3 (32), so a per-rank KL mean would weight the rows wrongly.
The parameter criterion is `test_train_step_matches_jax`'s, step for
step: every element within 2 lr for each step taken (Adam moves an element
by at most about lr a step, so a sign that flips on a near-zero gradient
costs 2 lr; attention's key bias has a gradient of zero in exact
arithmetic, and Adam scales its rounding to +-lr), and under 0.1% of them
more than 1e-6 off."""

import concurrent.futures
import dataclasses
import multiprocessing as mp
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_rvc.core import config as jax_config
from tpu_rvc.train import data as jax_data
from tpu_rvc.train.extract import extract_f0 as jax_extract_f0
from tpu_rvc.train.step import create_train_state as jax_create_train_state
from tpu_rvc.train.step import make_train_step

from tpu_rvc_torch.audio.io import save_wav
from tpu_rvc_torch.core import config
from tpu_rvc_torch.parallel import multihost
from tpu_rvc_torch.tools.dist_steps import (Ranks, full_params, make_batch,
                                            run_steps)
from tpu_rvc_torch.train import data
from tpu_rvc_torch.train.extract import extract_f0, extract_features
from tpu_rvc_torch.train.loop import run_training
from tpu_rvc_torch.train.step import create_train_state

from _torch_parity import SMALL_HUBERT, hubert_pair, single_threaded_child
from test_torch_train import TERMS, jax_trees, tiny
from test_torch_train_data import (fake_experiment, mute_experiment, voice,
                                   tiny_mute_hp)

LENGTHS = (24, 19, 24, 13)
T = 24
SEED = 3
HP = dataclasses.replace(tiny(config), train=dataclasses.replace(
    tiny(config).train, batch_size=4))
JAX_HP = tiny(jax_config)
LR = HP.train.learning_rate
PINNED = make_batch(HP, LENGTHS, 5, T, pins=(3, 7, 2, 1))
UNPINNED = make_batch(HP, LENGTHS, 6, T)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in tests/test_torch_train.py: a GAN step with torch's default
    thread pool in each of the suite's workers oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_params_close(got, want, steps, what):
    """Every element within 2 lr a step, under 0.1% beyond 1e-6; returns
    the max abs difference."""
    assert set(got) == set(want)
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    worst = float(diff.max())
    assert worst <= 2 * LR * steps * 1.01, f"{what}: {worst}"
    assert float((diff > 1e-6).float().mean()) < 1e-3, what
    return worst


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def jax_steps(g, d):
    """tpu_rvc's step twice on the pinned batch from the weights (g, d),
    in a process of its own, compiled at XLA's backend optimization level
    0 (a shorter compile, the same function) -> each step's loss terms
    and grad norms."""
    single_threaded_child()
    jstate, net_g, net_d = jax_create_train_state(
        JAX_HP, jax.random.PRNGKey(0), g_params=g, d_params=d)
    jbatch = {k: jnp.asarray(v) for k, v in PINNED.items()}
    key = jax.random.PRNGKey(1)
    jstep = make_train_step(net_g, net_d, JAX_HP, donate=False).lower(
        jstate, jbatch, key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    metrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, jbatch, key)
        metrics.append({k: float(m[k]) for k in TERMS})
    return metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two gloo ranks on a (2, 1) mesh (replicated: the gradients
    all-reduced by the step) for 2 pinned then 2 unpinned steps, and four
    on a (2, 2) mesh (HSDP) for the 2 pinned steps, started together;
    meanwhile the port's one-process step on all 4 rows and the JAX step
    on the same weights."""
    root = tmp_path_factory.mktemp("dist")
    common = {"case": "steps", "hp": HP, "seed": SEED, "device": "cpu",
              "backend": "gloo", "timeout_s": 60}
    repl = Ranks(dict(common, layouts=[(2, 1)],
                      batches=[PINNED, PINNED, UNPINNED, UNPINNED],
                      snapshots=[2, 4], desync=True,
                      out=str(root / "repl")), 2)
    hsdp = Ranks(dict(common, layouts=[(2, 2)], batches=[PINNED, PINNED],
                      snapshots=[2], out=str(root / "hsdp")), 4)

    state = create_train_state(HP, seed=SEED, device="cpu")
    g, d = jax_trees(state)

    # XLA compiles the JAX step in a spawned process while torch runs its
    # steps here (in a thread, its tracing held the interpreter lock)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=mp.get_context("spawn")) as pool:
        jax_metrics = pool.submit(jax_steps, g, d)
        one, _, one_params = run_steps(
            state, [PINNED, PINNED, UNPINNED, UNPINNED], (2, 4), full_params)
        out = dict(one=one, one_params=one_params,
                   jax=jax_metrics.result(timeout=300),
                   repl=repl.wait(180), hsdp=hsdp.wait(180))
    shutil.rmtree(root)
    return out


# ---------------------------------------------------------------------------
# the library's pure parts (`fsdp_spec` is held in tests/test_torch_fsdp.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size,world", [(2, 2), (4, 2), (4, 4)])
def test_epoch_local_slice_matches_jax(tmp_path, batch_size, world):
    """Both packages' batchers on one experiment (each its own copy, as
    both cache spectrograms): the same global plan, each rank's rows equal
    to the JAX rank's, and the ranks' rows disjoint and covering the
    global batch, row for row."""
    fake_experiment(tmp_path / "port", np.random.default_rng(0))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    hp = config.HParams(version="v2", data=config.DataConfig(
        sampling_rate=48000, filter_length=1024, hop_length=480,
        win_length=1024, n_mel_channels=32))
    jhp = jax_config.HParams(version="v2", data=jax_config.DataConfig(
        sampling_rate=48000, filter_length=1024, hop_length=480,
        win_length=1024, n_mel_channels=32))
    batchers = []
    for pkg, d, h in ((data, tmp_path / "port", hp),
                      (jax_data, tmp_path / "jax", jhp)):
        path = pkg.write_filelist(str(d), "v2", True, 0, "48k")
        batchers.append(pkg.BucketBatcher(pkg.RVCDataset(path, h),
                                          batch_size=batch_size, seed=7))
    ours, theirs = batchers
    assert ours._plans(2, 0, 1) == theirs._plans(2, 0, 1)
    full = list(ours.epoch(2))
    local = [list(ours.epoch_local_slice(2, r, world)) for r in range(world)]
    for r in range(world):
        want = list(theirs.epoch_local_slice(2, r, world))
        assert len(local[r]) == len(want) == len(full)
        for got, w, f in zip(local[r], want, full):
            assert set(got) == set(w)
            for k in got:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-4,
                                           atol=1e-4, err_msg=k)
                np.testing.assert_array_equal(got[k], f[k][r::world])
    with pytest.raises(ValueError, match="not divisible"):
        next(ours.epoch_local_slice(2, 0, 3))


def test_single_process_helpers():
    """Without a group: one process, primary, no collectives, rows onto
    the device as they are, and the resume check passes its value."""
    assert not multihost.is_multiprocess()
    assert multihost.is_primary()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.data_group() is None
    batch = {"x": np.arange(16, dtype=np.float32).reshape(8, 2),
             "y": np.arange(8, dtype=np.int32)}
    out = multihost.global_batch_from_local(batch, "cpu")
    for k in batch:
        assert out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), batch[k])
    assert multihost.assert_same_across_hosts(5, "resume start_epoch") == 5


# ---------------------------------------------------------------------------
# the global-batch step
# ---------------------------------------------------------------------------

def test_dp_step_matches_one_process(runs):
    """Each rank's loss terms and grad norms within 1e-5 relative of the
    port's one-process step on all 4 rows, at both pinned steps (the KL
    among them: undo its scaling and loss_kl is 2.9e-3 off)."""
    worst = 0.0
    for r, res in enumerate(runs["repl"]):
        for i in range(2):
            got = res["layouts"][0]["metrics"][i]
            for k in TERMS:
                e = rel(got[k], runs["one"][i][k])
                assert e <= 1e-5, f"rank {r} step {i + 1} {k}: {e}"
                worst = max(worst, e)
    print(f"2 ranks against one process: worst relative {worst:.2e}")


def test_dp_step_matches_jax(runs):
    """Both ranks' terms within 1e-3 relative of tpu_rvc's step on the
    same 4 rows and weights, at both pinned steps."""
    for res in runs["repl"]:
        for i in range(2):
            got = res["layouts"][0]["metrics"][i]
            for k in TERMS:
                want = runs["jax"][i][k]
                assert abs(got[k] - want) <= 1e-3 * abs(want), (i, k)


def test_dp_ranks_hold_identical_parameters(runs):
    for res in runs["repl"]:
        snaps = res["layouts"][0]["snapshots"]
        assert snaps[2]["same_as_rank0"] and snaps[4]["same_as_rank0"]
        assert res["multiprocess"]
    assert [res["primary"] for res in runs["repl"]] == [True, False]


def test_dp_unpinned_steps_match_one_process(runs):
    """Two unpinned steps after the pinned ones: every row draws its slice,
    posterior eps and sine noise from a generator keyed on its row of the
    global batch, so the ranks draw what one process draws."""
    got = runs["repl"][0]["layouts"][0]["snapshots"][4]["params"]
    worst = assert_params_close(got, runs["one_params"][4], 4,
                                "after 2 pinned + 2 unpinned steps")
    print(f"unpinned: max abs {worst:.2e} (2 lr = {2 * LR:.0e})")
    for i in (2, 3):
        got = runs["repl"][0]["layouts"][0]["metrics"][i]
        for k in TERMS:
            assert rel(got[k], runs["one"][i][k]) <= 1e-4, (i, k)


def test_assert_same_across_hosts_raises_the_jax_message(runs):
    assert runs["repl"][0]["desync"] is None
    assert runs["repl"][1]["desync"] == (
        "multihost desync: resume start_epoch is 8 on process 1 but 7 on "
        "rank 0 — the experiment dir (checkpoints) must be visible to "
        "every host, e.g. on shared storage")


# ---------------------------------------------------------------------------
# HSDP
# ---------------------------------------------------------------------------

def test_hsdp_state_stays_sharded(runs):
    for res in runs["hsdp"]:
        before, after = res["layouts"][0]["sharded_frac"]
        assert before >= 0.5 and after >= 0.5
        assert res["layouts"][0]["snapshots"][2]["same_as_rank0"]


def test_hsdp_step_matches_replicated_and_one_process(runs):
    """(2, 2) against (2, 1) and one process: every loss term within 1e-5
    relative at both steps (the JAX test allows 2e-3 on the first step's
    loss_gen_all), grad norms within 1e-4 (on the CPU torch's fp32 norm of
    a 5 M-element tensor can be 6e-4 off its float64 value; a sharded norm
    adds two halves' norms, and the one-process grad_norm_d reads 2.6e-5
    from it); parameters after two steps to the 2-lr criterion."""
    worst = 0.0
    for res in runs["hsdp"]:
        for i in range(2):
            got = res["layouts"][0]["metrics"][i]
            for want in (runs["one"][i],
                         runs["repl"][0]["layouts"][0]["metrics"][i]):
                for k in TERMS:
                    e = rel(got[k], want[k])
                    limit = 1e-4 if k.startswith("grad_norm") else 1e-5
                    assert e <= limit, (i, k, e)
                    if k == "loss_gen_all":
                        worst = max(worst, e)
    print(f"HSDP loss_gen_all: worst relative {worst:.2e}")
    got = runs["hsdp"][0]["layouts"][0]["snapshots"][2]["params"]
    for want in (runs["one_params"][2],
                 runs["repl"][0]["layouts"][0]["snapshots"][2]["params"]):
        assert_params_close(got, want, 2, "HSDP after 2 steps")


# ---------------------------------------------------------------------------
# run_training, the CLI, the extractors
# ---------------------------------------------------------------------------

def test_run_training_two_ranks(tmp_path):
    """run_training in 2 gloo ranks on one experiment dir, 2 epochs, beside
    a one-process run on a copy: only rank 0 writes a checkpoint, G_2.pth
    or the small model, and its G_2.pth matches the one-process run's."""
    hp = tiny_mute_hp(config)
    dp, one = (mute_experiment(tmp_path / n) for n in ("dp", "one"))
    ranks = Ranks({"case": "run_training", "hp": hp, "device": "cpu",
                   "backend": "gloo", "timeout_s": 60, "exp": str(dp),
                   "epochs": 2, "name": "m", "out": str(tmp_path / "out")},
                  2)
    want = run_training(str(one), hp, total_epochs=2, save_every_epoch=2,
                        name="m", log_fn=lambda s: None, tensorboard=False,
                        device="cpu")
    res = ranks.wait(180)
    assert res[1]["saved"] == []
    assert sorted(os.path.basename(p) for p in res[0]["saved"]) == [
        "G_2.pth", "m.pth", "state_2.pt"]
    for k, v in want.items():
        np.testing.assert_allclose(res[0]["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    steps = torch.load(one / "state_2.pt", map_location="cpu",
                       weights_only=True)["state"]["step"]
    g = [torch.load(e / "G_2.pth", map_location="cpu",
                    weights_only=True)["model"] for e in (dp, one)]
    assert_params_close(*g, steps, "G_2.pth")
    for e in (dp, one):
        (e / "state_2.pt").unlink()


def test_initialize_from_torchrun_environment():
    """`initialize()` without arguments joins from RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT, as torchrun sets them: gloo for the CPU,
    rank 0 primary, a sum over both ranks."""
    import subprocess
    import sys
    from tpu_rvc_torch.tools.dist_steps import REPO, free_port

    code = ("import torch, torch.distributed as dist\n"
            "from tpu_rvc_torch.parallel import multihost as mh\n"
            "dev = mh.initialize(device='cpu', timeout_s=60)\n"
            "t = torch.ones(1); dist.all_reduce(t)\n"
            "print(mh.process_index(), mh.process_count(), dev,"
            " dist.get_backend(), float(t), mh.is_primary())\n"
            "mh.shutdown()\n")
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
        stderr=subprocess.DEVNULL, env=dict(
            os.environ, PYTHONPATH=REPO, RANK=str(r), LOCAL_RANK=str(r),
            WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0].split() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["0", "2", "cpu", "gloo", "2.0", "True"],
                    ["1", "2", "cpu", "gloo", "2.0", "False"]]


def test_train_cli_refuses_process_flags_without_coordinator(tmp_path):
    from tpu_rvc_torch.apps.train import main
    for flags in (["--num-processes", "2"], ["--process-id", "1"]):
        with pytest.raises(SystemExit) as e:
            main(["train", "--exp-dir", str(tmp_path), "--device", "cpu"]
                 + flags)
        assert str(e.value.code).startswith(
            "--num-processes/--process-id require --coordinator ip:port")


def test_extract_parts_cover_disjoint_files(tmp_path):
    """extract_f0 and extract_features with part/n_parts: the parts take
    disjoint files that cover the experiment, f0's the same files as the
    JAX extractor's parts."""
    exp, jexp = tmp_path / "port", tmp_path / "jax"
    for d in (exp, jexp):
        (d / "1_16k_wavs").mkdir(parents=True)
        for i in range(5):
            save_wav(str(d / "1_16k_wavs" / f"{i}.wav"),
                     voice(0.6, 30 + i, sr=16000, gaps=()), 16000)
    hub, _ = hubert_pair(SMALL_HUBERT, 21)
    seen = {"f0": [], "feat": []}
    for part in range(2):
        before = set(os.listdir(exp / "2a_f0")) if part else set()
        assert extract_f0(str(exp), "pm", device="cpu", part=part,
                          n_parts=2) == []
        assert jax_extract_f0(str(jexp), "pm", part=part, n_parts=2) == []
        new = set(os.listdir(exp / "2a_f0")) - before
        assert new == set(os.listdir(jexp / "2a_f0")) - before
        seen["f0"].append(new)
        before = set(os.listdir(exp / "3_feature768")) if part else set()
        assert extract_features(str(exp), "v2", hubert=hub, device="cpu",
                                part=part, n_parts=2) == []
        seen["feat"].append(set(os.listdir(exp / "3_feature768")) - before)
    for kind, ext in (("f0", ".wav.npy"), ("feat", ".npy")):
        a, b = seen[kind]
        assert not a & b and len(a) == 3 and len(b) == 2
        assert a | b == {f"{i}{ext}" for i in range(5)}
