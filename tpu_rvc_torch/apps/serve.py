"""Realtime voice-conversion serving daemon of the PyTorch / CUDA port
(counterpart of apps/serve.py; a surface beyond the reference, whose
realtime path is one gui.py process per user, infer/lib/rtrvc.py:19).

Serves N concurrent streaming sessions from one card by batching every
active stream into one block on the device per tick
(tpu_rvc_torch.pipeline.serve.SlotScheduler over FusedStreamGraph).

Wire protocol (TCP, mono float32 PCM at the server's sample rate), byte
for byte that of apps/serve.py, so either package's client talks to either
server:

    frame := tag(1 byte) + length(u32 big-endian) + payload
    tag "J": UTF-8 JSON control message
    tag "A": float32 little-endian PCM samples

  server -> client on connect: J {"ok": true, "slot": n, "samplerate": sr,
                                  "block_frame": bf}
           (or J {"ok": false, "error": "server full"} and close)
  client -> server: A frames of input audio (any size; the server
           re-blocks), J {"cmd": "stats"} -> J stats reply,
           J {"cmd": "set_key"|"set_index_rate", "value": v} (engine-wide,
           shared by all slots, as the batch shares its settings),
           J {"cmd": "bye"} -> detach and close.
  server -> client: A frames of converted audio (block_frame samples per
           processed block, SOLA-merged).

Usage:
  python -m tpu_rvc_torch.apps.serve --model voice.pth [--index idx.npz]
         [--slots 8] [--port 7866] [--block-time 0.25] [--device cuda] ...
Client demo (also the tests' harness):
  python -m tpu_rvc_torch.apps.serve --client in.wav out.wav --port 7866
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import struct
import threading
import time

import numpy as np


# ---------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------

def send_frame(sock: socket.socket, tag: bytes, payload: bytes) -> None:
    sock.sendall(tag + struct.pack(">I", len(payload)) + payload)


def send_json(sock: socket.socket, obj) -> None:
    send_frame(sock, b"J", json.dumps(obj).encode())


def send_audio(sock: socket.socket, pcm: np.ndarray) -> None:
    send_frame(sock, b"A", np.asarray(pcm, "<f4").tobytes())


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def recv_frame(sock: socket.socket):
    head = recv_exact(sock, 5)
    tag, n = head[:1], struct.unpack(">I", head[1:])[0]
    return tag, recv_exact(sock, n)


# ---------------------------------------------------------------------
# server
# ---------------------------------------------------------------------

class VCServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, scheduler, poll: float = 0.002):
        self.scheduler = scheduler
        self.poll = poll
        self._stop = threading.Event()
        self._sched_thread = threading.Thread(target=self._run_scheduler,
                                              daemon=True)
        super().__init__(addr, _Handler)
        self._sched_thread.start()

    def _run_scheduler(self) -> None:
        """One thread advances every session: tick whenever an active slot
        has a full block queued (faster than realtime when clients stream
        faster, as in a file conversion)."""
        while not self._stop.is_set():
            if self.scheduler.ready():
                self.scheduler.tick()
            else:
                # idle: deliver a pipelined block in flight before napping
                self.scheduler.flush()
                time.sleep(self.poll)

    def shutdown(self):
        """Stop serving and end the scheduler thread (joined, so that no
        tick runs on after this returns)."""
        self._stop.set()
        super().shutdown()
        self._sched_thread.join()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):  # one thread per client
        sched = self.server.scheduler
        sock = self.request
        # the handler thread (JSON replies) and the writer thread (audio
        # frames) share the socket: sends are serialised, or the
        # length-prefixed frames interleave and the client loses its place
        wlock = threading.Lock()

        def reply(obj):
            with wlock:
                send_json(sock, obj)

        try:
            slot = sched.attach()
        except RuntimeError as e:
            reply({"ok": False, "error": str(e)})
            return
        reply({"ok": True, "slot": slot,
               "samplerate": sched.sr,
               "block_frame": sched.block_frame})
        stop = threading.Event()
        writer = threading.Thread(target=self._writer,
                                  args=(sock, sched, slot, stop, wlock),
                                  daemon=True)
        writer.start()
        try:
            while True:
                tag, payload = recv_frame(sock)
                if tag == b"A":
                    sched.submit(slot, np.frombuffer(payload, "<f4"))
                elif tag == b"J":
                    msg = json.loads(payload)
                    cmd = msg.get("cmd")
                    if cmd == "stats":
                        reply(sched.stats())
                    elif cmd == "set_key":
                        sched.engine.set_key(float(msg["value"]))
                    elif cmd == "set_index_rate":
                        sched.engine.set_index_rate(float(msg["value"]))
                    elif cmd == "bye":
                        break
                    else:
                        reply({"ok": False,
                               "error": f"unknown cmd {cmd}"})
        except (ConnectionError, OSError):
            pass
        finally:
            stop.set()
            sched.detach(slot)

    @staticmethod
    def _writer(sock, sched, slot, stop, wlock):
        while not stop.is_set():
            out = sched.collect(slot)
            if len(out):
                try:
                    with wlock:
                        send_audio(sock, out)
                except OSError:
                    return
            else:
                time.sleep(0.002)


# ---------------------------------------------------------------------
# client (demo and test harness)
# ---------------------------------------------------------------------

def stream_file(host: str, port: int, in_path: str, out_path: str,
                timeout: float = 300.0) -> dict:
    """Stream a wav through the server block by block and write the
    converted result; returns the server's final stats."""
    from tpu_rvc_torch.audio.io import load_audio, save_wav

    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(timeout)  # guards the whole exchange; frames stay whole
    tag, payload = recv_frame(sock)
    hello = json.loads(payload)
    if not hello.get("ok"):
        raise RuntimeError(hello.get("error"))
    sr, bf = hello["samplerate"], hello["block_frame"]
    audio = load_audio(in_path, sr)
    n_blocks = len(audio) // bf
    want = n_blocks * bf
    out = np.zeros(0, np.float32)
    for i in range(n_blocks):
        send_audio(sock, audio[i * bf:(i + 1) * bf])
    while len(out) < want:
        tag, payload = recv_frame(sock)
        if tag == b"A":
            out = np.concatenate([out, np.frombuffer(payload, "<f4")])
    send_json(sock, {"cmd": "stats"})
    stats = None
    while stats is None:
        tag, payload = recv_frame(sock)
        if tag == b"J":
            stats = json.loads(payload)
    send_json(sock, {"cmd": "bye"})
    sock.close()
    save_wav(out_path, out[:want], sr)
    return stats


# ---------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------

def build_engine(args):
    """The shared engine from the command line's arguments: the small
    model, HuBERT (`--hubert random` draws HuBERT-base from seed 0), the
    index, on `--device`."""
    from tpu_rvc_torch.models.loader import load_synthesizer
    from tpu_rvc_torch.pipeline.rt import RealtimeVC
    from tpu_rvc_torch.retrieval.index import FeatureIndex

    synth, meta = load_synthesizer(args.model, args.device)
    version = meta.get("version", "v2")
    if args.hubert == "random":
        from tpu_rvc_torch.models.hubert import hubert_for_version
        hub = hubert_for_version(version, args.device, seed=0)
    else:
        from tpu_rvc_torch.ckpt.hubert_loader import load_hubert_base
        hub = load_hubert_base(args.hubert, version, args.device)
    index = FeatureIndex.load(args.index) if args.index else None
    return RealtimeVC(
        hubert=hub, synth=synth, version=version,
        if_f0=int(meta.get("f0", 1)), index=index,
        index_rate=args.index_rate, f0_up_key=args.f0_up_key,
        rmvpe_root=args.rmvpe_root, device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tpu_rvc_torch.apps.serve",
        description="tpu_rvc_torch streaming server")
    p.add_argument("--model")
    p.add_argument("--index", default="")
    p.add_argument("--hubert", default="assets/hubert/hubert_base.pt")
    p.add_argument("--rmvpe-root", default="assets/rmvpe")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7866)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--samplerate", type=int, default=48000)
    p.add_argument("--block-time", type=float, default=0.25)
    p.add_argument("--crossfade-time", type=float, default=0.05)
    p.add_argument("--extra-time", type=float, default=2.5)
    p.add_argument("--f0-method", default="rmvpe",
                   choices=("pm", "rmvpe", "fcpe"),
                   help="f0 on the card inside the batched tick; fcpe reads "
                        "assets/fcpe/fcpe.pt")
    p.add_argument("--f0-up-key", type=float, default=0.0)
    p.add_argument("--index-rate", type=float, default=0.0)
    p.add_argument("--pipelined", action="store_true",
                   help="overlap each tick's device-to-host fetch with the "
                        "next tick's host work and queueing (one more block "
                        "of delivery latency; the tick's critical path is "
                        "the longer of device and host work, not their sum)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default: cuda)")
    p.add_argument("--client", nargs=2, metavar=("IN", "OUT"),
                   help="run as a demo client instead: stream IN -> OUT")
    args = p.parse_args(argv)

    if args.client:
        stats = stream_file(args.host, args.port, *args.client)
        print(json.dumps(stats))
        return

    if not args.model:
        p.error("--model is required to serve")
    from tpu_rvc_torch.pipeline.serve import SlotScheduler
    engine = build_engine(args)
    sched = SlotScheduler(engine, args.slots, samplerate=args.samplerate,
                          block_time=args.block_time,
                          crossfade_time=args.crossfade_time,
                          extra_time=args.extra_time,
                          f0method=args.f0_method,
                          pipelined=args.pipelined)
    srv = VCServer((args.host, args.port), sched)
    print(f"tpu_rvc_torch streaming server on {args.host}:{args.port} "
          f"({args.slots} slots, {sched.block_frame} samples/block "
          f"@ {args.samplerate} Hz, {engine.device})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
