"""The port's conversion and asset apps against tpu_rvc's CLIs, on the CPU:
`python -m tpu_rvc_torch.apps.convert` (chunk-parallel and with a manual
f0 curve), `apps.convert_batch` and `apps.assets`, driven through their
`main(argv)` with `--device cpu`, beside the library calls
(`VC.vc_single(chunk_parallel=...)`) and beside `apps/cli/*.py` run
through their own `main()`.

Both packages load one small model `.pth`; HuBERT-base would make the JAX
compile the slowest part of the file, so both packages' `load_hubert_base`
hand out one small HuBERT pair (tests/_torch_parity.py), and `VC.get_vc`
is wrapped to make the pipeline deterministic (noise_scale 0) and to give
it a small chunk geometry, so that an 11 s file is converted in 3 chunks.
Downloads are driven against an `http.server` on 127.0.0.1 serving a
temporary directory: nothing is fetched from outside the machine."""

import contextlib
import functools
import hashlib
import http.server
import importlib.util
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import tpu_rvc.ckpt.hubert_loader as jax_hubert_loader
from tpu_rvc.ckpt.torch_pth import save_pth
from tpu_rvc.pipeline.vc import VC as JaxVC
from tpu_rvc.utils import assets as jax_assets

import tpu_rvc_torch.ckpt.hubert_loader as hubert_loader
from tpu_rvc_torch.apps import assets as assets_app
from tpu_rvc_torch.apps import convert, convert_batch
from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.models.synthesizer import Synthesizer
from tpu_rvc_torch.pipeline.vc import VC
from tpu_rvc_torch.retrieval.index import FeatureIndex
from tpu_rvc_torch.utils import assets

from _torch_parity import (SMALL_HUBERT, SMALL_SYNTH, hubert_pair,
                           reference_state, seeded)

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CONFIG = [129, 32, 32, 32, 64, 2, 1, 3, 0.0, "1", [3], [[1, 3, 5]],
                [10, 16], 64, [20, 32], 2, 16, 16000]
GEOMETRY = dict(t_query=SR, t_center=4 * SR, t_max=5 * SR)  # 11 s: 3 chunks
FULL_SCALE = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    ph = 2 * np.pi * np.cumsum(180 + 40 * np.sin(2 * np.pi * 0.5 * t)) / SR
    x = (0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)) * (
        0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
    return (x + 0.005 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small model .pth (tpu_rvc's writer, fp16, weight norm as (g, v)),
    an index both packages read, an 11 s voice, a manual f0 curve."""
    d = tmp_path_factory.mktemp("convert_apps")
    sd = reference_state(seeded(Synthesizer, 81, **SMALL_SYNTH), 82)
    save_pth({"weight": {k: w.astype(np.float16) for k, w in sd.items()},
              "config": SMALL_CONFIG, "sr": "40k", "f0": 1, "version": "v2",
              "info": "t"}, str(d / "m.pth"))
    vecs = np.random.default_rng(83).standard_normal((200, 64)).astype(
        np.float32)
    FeatureIndex(vecs, (vecs * vecs).sum(1)).save(str(d / "m.npz"))
    save_wav(str(d / "long.wav"), voice(11.0, 1), SR)
    curve = np.stack([np.linspace(0, 11, 45), np.linspace(150, 260, 45)], 1)
    np.savetxt(str(d / "curve.csv"), curve, delimiter=",", fmt="%.4f")
    hub, jax_hub_vars = hubert_pair(SMALL_HUBERT, 84)
    from tpu_rvc.models.hubert import Hubert as JaxHubert
    return dict(dir=d, model=str(d / "m.pth"), index=str(d / "m.npz"),
                wav=str(d / "long.wav"), curve=str(d / "curve.csv"), hub=hub,
                jax_hub=(JaxHubert(**SMALL_HUBERT), jax_hub_vars))


@pytest.fixture
def small_vc(files, monkeypatch):
    """Both packages' VC load the small HuBERT and build deterministic
    pipelines with the small chunk geometry."""
    monkeypatch.setattr(hubert_loader, "load_hubert_base",
                        lambda path, version="v2", device=None: files["hub"])
    monkeypatch.setattr(jax_hubert_loader, "load_hubert_base",
                        lambda path, version="v2": files["jax_hub"])

    def wrap(cls):
        inner = cls.get_vc

        @functools.wraps(inner)
        def get_vc(self, *a, **kw):
            meta = inner(self, *a, **kw)
            pipe = self.pipeline
            pipe.noise_scale, pipe.deterministic = 0.0, True
            for k, v in GEOMETRY.items():
                setattr(pipe, k, v)
            return meta
        monkeypatch.setattr(cls, "get_vc", get_vc)

    wrap(VC)
    wrap(JaxVC)


def jax_cli(name, argv, monkeypatch, capsys):
    """Run apps/cli/<name>.py's main() with `argv`, return its stdout."""
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", os.path.join(REPO, "apps", "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def read_int16(path):
    """A 16-bit WAV's samples as int16, and its rate."""
    x, sr = load_wav(path)
    return np.round(x * 32768.0).astype(np.int16), sr


def int16_err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float64) - b).max() / 32768)


@pytest.mark.parametrize("mode", ["chunk_parallel", "f0_file"])
def test_convert_app_matches_library_and_jax(files, small_vc, tmp_path,
                                             monkeypatch, capsys, mode):
    """`apps.convert --chunk-parallel` writes what
    `VC.vc_single(chunk_parallel=True)` returns, bit for bit, within 2e-3
    of full scale of tpu_rvc's CLI (convert_long on its 8 devices); with
    --f0-file both packages take the sequential path."""
    extra = (["--chunk-parallel"] if mode == "chunk_parallel"
             else ["--chunk-parallel", "--f0-file", files["curve"]])
    common = ["--input", files["wav"], "--model", files["model"], "--index",
              files["index"], "--hubert", "small", "--f0-method", "pm",
              "--rms-mix-rate", "0.25", *extra]
    out = str(tmp_path / "port.wav")
    capsys.readouterr()
    convert.main(common + ["--output", out, "--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    jout = str(tmp_path / "jax.wav")
    jax_lines = jax_cli("convert", common + ["--output", jout, "--aot-cache",
                                             "", "--fp32"],
                        monkeypatch, capsys).strip().splitlines()
    got, sr = read_int16(out)
    want, jsr = read_int16(jout)

    vc = VC(hubert_path="small", device="cpu")
    vc.get_vc(files["model"])
    f0_file = (None if mode == "chunk_parallel"
               else np.loadtxt(files["curve"], delimiter=",",
                               dtype=np.float32))
    kw = dict(f0_method="pm", index=FeatureIndex.load(files["index"]),
              index_rate=0.66, rms_mix_rate=0.25, f0_file=f0_file)
    _, (lsr, lib) = vc.vc_single(0, files["wav"], chunk_parallel=True, **kw)
    _, (_, seq) = vc.vc_single(0, files["wav"], **kw)
    err = int16_err(got, want)
    print(f"{mode}: app vs library equal {np.array_equal(got, lib)}, app "
          f"vs JAX CLI {err:.2e} of full scale, parallel vs sequential "
          f"max {int(np.abs(lib.astype(int) - seq).max())} LSB; "
          f"lines {port_lines[0]!r} | {jax_lines[0]!r}")
    assert sr == jsr == lsr == SR
    assert np.array_equal(got, lib)
    assert err < FULL_SCALE
    if mode == "f0_file":   # the sequential path, bit for bit
        assert np.array_equal(lib, seq)
    assert port_lines[:2] == jax_lines[:2]    # loaded ..., index: 200 x 64
    assert port_lines[2].startswith("npy: ") and \
        jax_lines[2].startswith("npy: ")
    assert port_lines[-1] == jax_lines[-1].replace(jout, out)


def test_convert_batch_app_matches_jax(files, small_vc, tmp_path,
                                       monkeypatch, capsys):
    """`apps.convert_batch` on a folder of three voices and a file that is
    not audio: one line a file in name order, the same statuses as
    tpu_rvc's CLI, files within 2e-3 of full scale of its files and
    equal to `vc_single`'s."""
    src = tmp_path / "in"
    src.mkdir()
    for i, seconds in enumerate((1.0, 1.2, 1.4)):
        save_wav(str(src / f"v{i}.wav"), voice(seconds, 10 + i), SR)
    (src / "z_broken.wav").write_bytes(b"not a wav file")
    common = ["--input-dir", str(src), "--model", files["model"],
              "--hubert", "small", "--f0-method", "pm"]
    capsys.readouterr()
    convert_batch.main(common + ["--output-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    jax_lines = jax_cli("convert_batch", common + [
        "--output-dir", str(tmp_path / "jax")], monkeypatch,
        capsys).strip().splitlines()
    def status(lines):
        return [(ln.split(" -> ")[0].rsplit("/", 1)[-1],
                 "Success" if " -> Success (" in ln else "failed")
                for ln in lines]

    print("port:", status(port_lines), "| jax:", status(jax_lines))
    assert status(port_lines) == status(jax_lines) == [
        ("v0.wav", "Success"), ("v1.wav", "Success"), ("v2.wav", "Success"),
        ("z_broken.wav", "failed")]
    vc = VC(hubert_path="small", device="cpu")
    vc.get_vc(files["model"])
    for i in range(3):
        got, _ = read_int16(str(tmp_path / "port" / f"v{i}.wav.wav"))
        want, _ = read_int16(str(tmp_path / "jax" / f"v{i}.wav.wav"))
        _, (_, lib) = vc.vc_single(0, str(src / f"v{i}.wav"),
                                   f0_method="pm", index_rate=0.66,
                                   rms_mix_rate=1.0)
        assert np.array_equal(got, lib)
        assert int16_err(got, want) < FULL_SCALE


# ---------------------------------------------------------------------------
# assets
# ---------------------------------------------------------------------------


def test_asset_keys_match_jax():
    """The repo's sha256.env parses to the JAX package's table and every
    key maps to the JAX package's path under assets/."""
    env = os.path.join(REPO, "sha256.env")
    sums = assets.load_checksums(env)
    assert sums == jax_assets.load_checksums(env) and len(sums) >= 30
    paths = {k: assets.asset_relpath(k) for k in sums}
    print(f"{len(sums)} keys, e.g. {list(paths.items())[:3]}")
    assert paths == {k: jax_assets.asset_relpath(k) for k in sums}
    for extra in ("model.bin", "plain", "odd_name_bin"):
        assert assets.asset_relpath(extra) == jax_assets.asset_relpath(extra)
    assert assets.load_checksums(os.path.join(REPO, "no_such.env")) == {}


def write_env(root, files):
    with open(os.path.join(root, "sha256.env"), "w") as f:
        for key, data in files.items():
            f.write(f"sha256_{key} = {hashlib.sha256(data).hexdigest()}\n")


@pytest.mark.parametrize("state", ["good", "missing", "corrupt"])
def test_check_all_assets(tmp_path, state):
    """check_all_assets and `apps.assets check` on a temporary root: good,
    one file missing, one file corrupt -- the same answer as tpu_rvc's."""
    root = str(tmp_path)
    payload = {"hubert_base_pt": b"hubert bytes",
               "v2_f0G48k_pth": b"generator bytes"}
    write_env(root, payload)
    for key, data in payload.items():
        path = os.path.join(root, "assets", assets.asset_relpath(key))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    target = os.path.join(root, "assets", "pretrained_v2", "f0G48k.pth")
    if state == "missing":
        os.unlink(target)
    elif state == "corrupt":
        with open(target, "r+b") as f:
            f.write(b"G")
    ok = assets.check_all_assets(root)
    with pytest.raises(SystemExit) as e:
        assets_app.main(["check", "--root", root])
    print(f"{state}: ok={ok}, exit {e.value.code}")
    assert ok == (state == "good") == jax_assets.check_all_assets(root)
    assert e.value.code == (0 if state == "good" else 1)
    assert assets.check_model(tmp_path / "assets", "hubert/hubert_base.pt",
                              hashlib.sha256(b"hubert bytes").hexdigest())


def test_gen_matches_jax_cli(tmp_path, capsys):
    """`apps.assets gen` writes the lines tpu_rvc's `gen` writes (run in a
    process of its own: it may exec native/checksum)."""
    paths = []
    for name, data in (("a.bin", b"alpha"), ("b.pth", b"\x00" * 3000)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    ours = str(tmp_path / "ours.env")
    assets_app.main(["gen", "--out", ours, *paths])
    theirs = str(tmp_path / "theirs.env")
    subprocess.run([sys.executable, os.path.join(REPO, "apps", "cli",
                                                 "assets.py"),
                    "gen", "--out", theirs, *paths], check=True, cwd=REPO,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    text = open(ours).read()
    print(text.strip())
    assert text == open(theirs).read()
    assert assets.load_checksums(ours) == {
        "a.bin": hashlib.sha256(b"alpha").hexdigest(),
        "b.pth": hashlib.sha256(b"\x00" * 3000).hexdigest()}


@contextlib.contextmanager
def local_mirror(directory):
    """An http.server on 127.0.0.1 (an ephemeral port) serving `directory`
    -> its base URL."""
    handler = functools.partial(_QuietHandler, directory=str(directory))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


def test_download_file_against_local_mirror(tmp_path):
    """download_file: a matching sha256 lands the file; a mismatch raises
    IOError and leaves neither the file nor its .part."""
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    (mirror / "w.bin").write_bytes(b"weights" * 1000)
    good = hashlib.sha256(b"weights" * 1000).hexdigest()
    dest = str(tmp_path / "root" / "sub" / "w.bin")
    with local_mirror(mirror) as url:
        assert assets.download_file(f"{url}/w.bin", dest, good) == dest
        assert assets.sha256_file(dest) == good
        bad = str(tmp_path / "root" / "bad.bin")
        with pytest.raises(IOError, match="sha256 mismatch"):
            assets.download_file(f"{url}/w.bin", bad, "0" * 64)
    print("fetched", os.path.getsize(dest), "bytes; mismatch refused")
    assert not os.path.exists(bad) and not os.path.exists(bad + ".part")


def test_download_all_and_attempt_report(tmp_path):
    """download_all_assets and `apps.assets download` fetch what is
    missing or corrupt from the mirror's layout; attempt_asset_report
    refetches a corrupt existing file (tests/test_aux.py:238), records a
    mirror that serves the wrong bytes and one that has nothing, and
    counts the assets that verify."""
    mirror = tmp_path / "mirror"
    payload = {rel: f"payload of {rel}".encode()
               for _, rel in assets.CORE_ASSETS}
    for rel, data in payload.items():
        (mirror / rel).parent.mkdir(parents=True, exist_ok=True)
        (mirror / rel).write_bytes(data)
    bad_mirror = tmp_path / "bad_mirror"
    bad_mirror.mkdir()
    (bad_mirror / "rmvpe.pt").write_bytes(b"<html>503</html>")
    root = str(tmp_path / "root")
    os.makedirs(os.path.join(root, "assets", "hubert"))
    with open(os.path.join(root, "assets", "hubert", "hubert_base.pt"),
              "wb") as f:
        f.write(b"<html>503 Service Unavailable</html>")
    keys = {"hubert_base_pt": "hubert_base.pt", "rmvpe_pt": "rmvpe.pt",
            "v2_f0G48k_pth": "pretrained_v2/f0G48k.pth",
            "v2_f0D48k_pth": "pretrained_v2/f0D48k.pth",
            "uvr5_vocals_onnx":
                "uvr5_weights/onnx_dereverb_By_FoxJoy/vocals.onnx"}
    write_env(root, {k: payload[rel] for k, rel in keys.items()})
    with local_mirror(bad_mirror) as bad_url, local_mirror(mirror) as url:
        rep = assets.attempt_asset_report(root, timeout=5.0,
                                          mirrors=(bad_url, url))
        assert assets.check_all_assets(root)
        os.unlink(os.path.join(root, "assets", "rmvpe", "rmvpe.pt"))
        with open(os.path.join(root, "assets", "pretrained_v2",
                               "f0D48k.pth"), "wb") as f:
            f.write(b"corrupt")
        assert not assets.check_all_assets(root)
        assets_app.main(["download", "--root", root, "--mirror", url])
    print("report:", {a["url"] and a["url"].rsplit("/", 1)[-1]: a["ok"]
                      for a in rep["attempts"]}, "all_ok", rep["all_ok"])
    assert rep["all_ok"] and sorted(rep["downloaded"]) == sorted(
        d for d, _ in assets.CORE_ASSETS)
    assert rep["dns_probe"]["127.0.0.1"]["ok"]
    hub = [a for a in rep["attempts"] if a["asset"] == "hubert/hubert_base.pt"]
    assert hub[0]["url"] is None and "sha256" in hub[0]["error"]
    assert any(a["ok"] for a in hub)
    rmvpe = [a for a in rep["attempts"] if a["asset"] == "rmvpe/rmvpe.pt"]
    assert not rmvpe[0]["ok"] and "sha256 mismatch" in rmvpe[0]["error"]
    assert rmvpe[1]["ok"] and rmvpe[1]["sha256_verified"]
    onnx = [a for a in rep["attempts"] if a["asset"].endswith("vocals.onnx")]
    assert not onnx[0]["ok"] and "404" in onnx[0]["error"]
    assert assets.check_all_assets(root)
