"""tpu_rvc_torch's serving loop alone on the CPU: the chunk queue's edge
cases; `SlotScheduler` with one slot against a `StreamSession`, pipelined
against serial, re-attach during a tick, capacity, concurrent clients; the
TCP server driven by both packages' clients; the serve app's --help
imports no JAX.  Sizes are those of tests/test_serve.py (16 kHz, 160 ms
blocks, pm).  (The scheduler against tpu_rvc's is held in
tests/test_torch_serve.py.)"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tpu_rvc.pipeline import serve as jax_serve

from tpu_rvc_torch.apps import serve as app
from tpu_rvc_torch.audio.io import load_wav, save_wav
from tpu_rvc_torch.pipeline import rt, serve

from _torch_parity import (SERVE_GEOMETRY, FakeClock, engine_pair,
                           serving_world, stream_voice)

BF = 2560  # 160 ms at 16 kHz
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return serving_world()


QUEUE_OPS = {
    "empty": [("pop", 0), ("pop", None), ("pop", 5)],
    "pop_zero_is_a_no_op": [("push", 5), ("push", 4), ("pop", 0),
                            ("pop", -3)],
    "split_a_chunk": [("push", 5), ("push", 4), ("pop", 7), ("pop", None)],
    "whole_chunks": [("push", 3), ("push", 3), ("push", 3), ("pop", 6),
                     ("pop", 3), ("pop", 1)],
    "more_than_queued": [("push", 4), ("pop", 9), ("push", 0), ("pop", None)],
    "clear": [("push", 6), ("clear", None), ("pop", None), ("push", 2),
              ("pop", 1), ("pop", 1)],
}


@pytest.mark.parametrize("case", sorted(QUEUE_OPS))
def test_chunk_queue_edge_cases(case):
    """Every operation gives what the JAX package's queue gives, and the
    lengths stay equal."""
    q, jq = serve._ChunkQueue(), jax_serve._ChunkQueue()
    at = 0
    for op, n in QUEUE_OPS[case]:
        if op == "push":
            pcm = np.arange(at, at + n, dtype=np.float32)
            at += n
            q.push(pcm), jq.push(pcm)
        elif op == "clear":
            q.clear(), jq.clear()
        else:
            got, want = q.pop(n), jq.pop(n)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert len(q) == len(jq)


def run_lockstep(sched, audios, n_blocks):
    """Attach one client per audio, submit everything, tick until idle:
    per slot, what was collected after each tick."""
    slots = [sched.attach() for _ in audios]
    for slot, audio in zip(slots, audios):
        sched.submit(slot, audio[: n_blocks * sched.block_frame])
    got = [[] for _ in slots]
    while sched.ready():
        sched.tick()
        for i, slot in enumerate(slots):
            got[i].append(sched.collect(slot))
    sched.flush()
    flushed = [sched.collect(slot) for slot in slots]
    stats = sched.stats()
    for slot in slots:
        sched.detach(slot)
    return got, flushed, stats


def test_one_slot_scheduler_equals_stream_session(world):
    """n_slots = 1 takes the unbatched graph; its stream is the fused
    StreamSession's, sample for sample."""
    port, _ = engine_pair(world)
    sched = serve.SlotScheduler(port, 1, f0method="pm", clock=FakeClock(),
                                **SERVE_GEOMETRY)
    assert sched.state["wav16"].dim() == 1
    audio = stream_voice(4 * BF, seed=34)
    got, _, stats = run_lockstep(sched, [audio], 4)
    assert stats["blocks"] == [4] and stats["underruns"] == [0]
    port2, _ = engine_pair(world)
    sess = rt.StreamSession(port2, f0method="pm", **SERVE_GEOMETRY)
    want = np.concatenate([sess.feed(audio[i * BF:(i + 1) * BF])
                           for i in range(4)])
    np.testing.assert_allclose(np.concatenate(got[0]), want, atol=1e-6)
    # a new client on the slot starts from a zeroed device state
    got2, _, _ = run_lockstep(sched, [audio], 1)
    np.testing.assert_allclose(got2[0][0], want[:BF], atol=1e-6)


def test_pipelined_equals_serial_one_tick_later(world):
    """pipelined=True: the first tick delivers nothing, each later tick the
    block before, flush() the last; the streams are serial mode's, sample
    for sample."""
    audios = [stream_voice(4 * BF, seed=35),
              stream_voice(4 * BF, seed=36, f0=320.0)]
    runs = {}
    for pipelined in (False, True):
        port, _ = engine_pair(world)
        sched = serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                                    pipelined=pipelined, **SERVE_GEOMETRY)
        runs[pipelined] = run_lockstep(sched, audios, 4)
        assert runs[pipelined][2]["blocks"] == [4, 4]
        assert runs[pipelined][2]["underruns"] == [0, 0]
    (ser, ser_flush, _), (pip, pip_flush, _) = runs[False], runs[True]
    for s in range(2):
        assert [len(x) for x in ser[s]] == [BF] * 4 and len(ser_flush[s]) == 0
        assert [len(x) for x in pip[s]] == [0] + [BF] * 3
        assert len(pip_flush[s]) == BF
        np.testing.assert_array_equal(
            np.concatenate(pip[s] + [pip_flush[s]]), np.concatenate(ser[s]))
    assert np.abs(np.concatenate(ser[0]) - np.concatenate(ser[1])).max() > 1e-3


@pytest.fixture(scope="module")
def sched(world):
    port, _ = engine_pair(world)
    return serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                               **SERVE_GEOMETRY)


@pytest.mark.parametrize("pipelined", [False, True])
def test_reattach_between_consume_and_deliver(world, pipelined):
    """A detach and attach while the block is in flight (serial: during
    the call; pipelined: also between the tick that consumed the input and
    the one that delivers) must not hand the old client's audio to the
    new one: the generation check."""
    port, _ = engine_pair(world)
    sched = serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                                pipelined=pipelined, **SERVE_GEOMETRY)
    s = sched.attach()
    sched.submit(s, stream_voice(2 * BF, seed=37))
    graph, took_over = sched.fused, []

    def hijack(state, seg, fed=None, fetch=True):
        out, st = graph(state, seg, fed=fed, fetch=fetch)
        sched.detach(s)
        took_over.append(sched.attach())
        return out, st

    if not pipelined:
        sched.fused = hijack
    sched.tick()
    sched.fused = graph
    if pipelined:  # tick 1 consumed the input; the client changes now
        assert len(sched.collect(s)) == 0
        sched.detach(s)
        took_over.append(sched.attach())
        sched.flush()
    assert took_over == [s]
    assert len(sched.collect(s)) == 0
    assert sched.stats()["blocks"][s] == 0
    # the new client is served from its own first block on
    sched.submit(s, stream_voice(BF, seed=38))
    sched.tick(), sched.flush()
    assert len(sched.collect(s)) == BF and sched.stats()["blocks"][s] == 1


def test_attach_detach_capacity(sched):
    a, b = sched.attach(), sched.attach()
    with pytest.raises(RuntimeError, match="server full"):
        sched.attach()
    sched.detach(a)
    c = sched.attach()
    assert c == a and sched.stats()["blocks"][c] == 0
    assert sched.stats()["active"] == 2
    sched.detach(b), sched.detach(c)
    assert sched.stats()["active"] == 0


def test_scheduler_under_concurrent_clients(world):
    """Five client threads share two slots with one tick thread, thread
    switches forced often: every client that got a slot receives exactly
    the blocks it submitted (2 x BF finite samples, never a previous
    occupant's), the counters add up, and no thread dies or hangs."""
    port, _ = engine_pair(world)
    sched = serve.SlotScheduler(port, 2, f0method="pm", clock=FakeClock(),
                                **SERVE_GEOMETRY)
    stop, errors, served = threading.Event(), [], []

    def ticker():
        while not stop.is_set():
            if sched.ready():
                sched.tick()
            else:
                stop.wait(0.001)

    def client(i):
        try:
            for turn in range(2):
                while True:
                    try:
                        slot = sched.attach()
                        break
                    except RuntimeError:
                        stop.wait(0.002)
                audio = stream_voice(2 * BF, seed=100 + 10 * i + turn)
                got = np.zeros(0, np.float32)
                for part in np.array_split(audio, 7):
                    sched.submit(slot, part)
                    got = np.concatenate([got, sched.collect(slot)])
                while len(got) < 2 * BF and not stop.is_set():
                    stop.wait(0.002)
                    got = np.concatenate([got, sched.collect(slot)])
                blocks = sched.stats()["blocks"][slot]
                sched.detach(slot)
                assert len(got) == 2 * BF and np.isfinite(got).all()
                assert blocks == 2
                served.append(i)
        except BaseException as e:  # reported by the main thread below
            errors.append(e)
            raise

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=ticker)] + [
        threading.Thread(target=client, args=(i,)) for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=120)
    finally:
        stop.set()
        threads[0].join(timeout=30)
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert sorted(served) == sorted(list(range(5)) * 2)
    st = sched.stats()
    assert st["active"] == 0 and st["underruns"] == [0, 0]
    assert st["ticks"] >= 10   # 20 blocks through 2 slots


def jax_package_client():
    """apps/serve.py of the JAX package, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_package_serve_app", os.path.join(REPO, "apps", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("client", ["port", "jax_package"])
def test_tcp_server_answers_both_packages_clients(sched, tmp_path, client):
    """The port's VCServer on an ephemeral port, driven over a real socket
    by the port's `stream_file` and by the JAX package's: the wire protocol
    is the same.  4 blocks in, 4 SOLA-merged blocks out, and a stats reply.
    The scheduler reads a hand-advanced clock, so no underrun can occur."""
    stream_file = (app.stream_file if client == "port"
                   else jax_package_client().stream_file)
    srv = app.VCServer(("127.0.0.1", 0), sched)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        in_path, out_path = str(tmp_path / "in.wav"), str(tmp_path / "o.wav")
        save_wav(in_path, stream_voice(4 * BF, seed=39), 16000)
        stats = stream_file("127.0.0.1", srv.server_address[1], in_path,
                            out_path, timeout=120.0)
        assert max(stats["blocks"]) >= 4
        assert stats["samplerate"] == 16000 and stats["block_frame"] == BF
        assert stats["underruns"] == [0, 0]
        y, sr = load_wav(out_path)
        assert sr == 16000 and len(y) == 4 * BF
        assert np.isfinite(y).all() and np.abs(y[BF:]).max() > 1e-3
    finally:
        srv.shutdown()
        srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive() and not srv._sched_thread.is_alive()


def test_server_full_and_unknown_command_over_the_wire(sched):
    """Raw frames over a socket: a third client of a 2-slot server is told
    "server full", an unknown command gets an error reply, set_key reaches
    the shared engine, stats come back as JSON."""
    srv = app.VCServer(("127.0.0.1", 0), sched)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    socks = []
    try:
        for want_ok in (True, True, False):
            s = socket.create_connection(srv.server_address, timeout=30)
            socks.append(s)
            tag, payload = app.recv_frame(s)
            hello = json.loads(payload)
            assert tag == b"J" and hello["ok"] is want_ok
            if not want_ok:
                assert "server full" in hello["error"]
        app.send_json(socks[0], {"cmd": "nonsense"})
        tag, payload = app.recv_frame(socks[0])
        assert json.loads(payload) == {"ok": False,
                                       "error": "unknown cmd nonsense"}
        app.send_json(socks[0], {"cmd": "set_key", "value": 3})
        app.send_json(socks[0], {"cmd": "stats"})
        tag, payload = app.recv_frame(socks[0])
        assert json.loads(payload)["active"] == 2
        assert sched.engine.f0_up_key == 3.0
        for s in socks[:2]:
            app.send_json(s, {"cmd": "bye"})
    finally:
        for s in socks:
            s.close()
        srv.shutdown()
        srv.server_close()
        sched.engine.set_key(0.0)
        for slot in range(2):
            sched.detach(slot)


def test_serve_app_help_imports_no_jax():
    """`python -m tpu_rvc_torch.apps.serve --help` prints its usage, and
    neither it nor the serving modules pull in jax, flax or tpu_rvc."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--help']\n"
        "try:\n"
        "    runpy.run_module('tpu_rvc_torch.apps.serve',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import tpu_rvc_torch.pipeline.serve, tpu_rvc_torch.pipeline.live\n"
        "import tpu_rvc_torch.audio.torchgate\n"
        "import tpu_rvc_torch.audio.native_ring\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_rvc', 'apps'))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "--slots" in out.stdout and "--device" in out.stdout
    assert "--aot-cache" not in out.stdout
    assert out.stdout.strip().endswith("no-jax-ok")
