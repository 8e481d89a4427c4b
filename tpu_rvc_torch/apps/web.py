"""The web app's backend (port of apps/web.py; reference web.py role).

The reference's named API endpoints (web.py:845-1536) on one `Api`
class: infer_convert, infer_convert_batch, uvr_convert, train_preprocess,
train_extract_f0_feature, train_index, train_start, train_start_all,
ckpt_merge, ckpt_modify, ckpt_show, ckpt_extract, export_onnx and the
dropdown helpers.  Two front ends:
  - the gradio Blocks of `tpu_rvc_torch/apps/webui.py` when gradio is
    importable, else
  - a stdlib JSON-over-HTTP server (POST /api/<endpoint>).

    python -m tpu_rvc_torch.apps.web --http-only [--port 7865] \\
        [--weight-root assets/weights] [--device cpu]

Every endpoint runs on the `Api`'s device, the card unless another is
named.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import threading
import time
import traceback
from collections import OrderedDict
from typing import Optional

from tpu_rvc_torch.core.device import resolve_device


class Api:
    def __init__(self, weight_root: str = "assets/weights",
                 index_root: str = "logs",
                 hubert_path: str = "assets/hubert/hubert_base.pt",
                 rmvpe_root: str = "assets/rmvpe",
                 uvr5_root: str = "assets/uvr5_weights", device=None):
        self.device = resolve_device(device)
        self.weight_root = weight_root
        self.index_root = index_root
        self.hubert_path = hubert_path
        self.rmvpe_root = rmvpe_root
        self.uvr5_root = uvr5_root
        self._vc = None
        # separators are kept per (model, agg), a bounded LRU: each one
        # holds its net's weights on the device, so sweeping agg values or
        # loading several UVR models must evict, not accumulate
        self._uvr = OrderedDict()
        self._uvr_capacity = 4

    # ------------- model and index discovery (reference web.py:90-112) ---
    def lookup_names(self):
        """Voice models in weight_root (reference lookup_names)."""
        if not os.path.isdir(self.weight_root):
            return []
        return sorted(n for n in os.listdir(self.weight_root)
                      if n.endswith(".pth"))

    def lookup_indices(self):
        """Feature indexes under index_root (reference lookup_indices
        web.py:98-104; .tpuidx.npz or .index, 'trained' ones skipped)."""
        out = []
        for root, _, files in os.walk(self.index_root):
            for name in files:
                if (name.endswith((".tpuidx.npz", ".index"))
                        and "trained" not in name):
                    out.append(os.path.join(root, name))
        return sorted(out)

    def lookup_uvr5_names(self):
        """UVR5 separation models (reference web.py:109-112)."""
        if not os.path.isdir(self.uvr5_root):
            return []
        return sorted(n.replace(".pth", "")
                      for n in os.listdir(self.uvr5_root)
                      if n.endswith(".pth") or "onnx" in n)

    def change_choices(self):
        """Refresh the dropdowns' choices (reference change_choices
        web.py:115)."""
        return {"names": [""] + self.lookup_names(),
                "indices": [""] + self.lookup_indices()}

    def clean(self):
        """Unload the current model (reference clean web.py:124)."""
        self._vc = None
        return {"value": "", "__type__": "update"}

    def change_voice(self, model_name: str):
        """Load a voice and report its metadata for the UI (reference
        VC.get_vc's gradio updates, infer/modules/vc/modules.py:32-115:
        speaker count, f0 flag, model info text)."""
        if not model_name:
            self.clean()
            return {"n_spk": 0, "if_f0": 1, "info": ""}
        vc, meta = self._get_vc(model_name)
        return {"n_spk": vc.n_spk, "if_f0": vc.if_f0, "sr": vc.tgt_sr,
                "info": str(meta.get("info", "")),
                "version": vc.version}

    def hash_similarity(self, id_a: str, id_b: str):
        """Model-ID similarity (reference web.py:1330 butmodelcmp)."""
        from tpu_rvc_torch.ckpt.hash import hash_similarity
        try:
            return {"similarity": float(hash_similarity(id_a, id_b))}
        except Exception as e:
            return {"similarity": None, "error": str(e)}

    # ---------------- inference tab ----------------
    def _get_vc(self, model_name: str):
        from tpu_rvc_torch.pipeline.vc import VC
        if self._vc is None:
            self._vc = VC(hubert_path=self.hubert_path,
                          rmvpe_root=self.rmvpe_root, device=self.device)
        path = (model_name if os.path.exists(model_name)
                else os.path.join(self.weight_root, model_name))
        meta = self._vc.get_vc(path)
        return self._vc, meta

    def infer_convert(self, sid: int, input_audio_path: str,
                      f0_up_key: int = 0, f0_method: str = "rmvpe",
                      file_index: str = "", index_rate: float = 0.66,
                      filter_radius: int = 3, resample_sr: int = 0,
                      rms_mix_rate: float = 1.0, protect: float = 0.33,
                      model_name: str = "", output_path: str = "out.wav",
                      f0_file: Optional[str] = None,
                      chunk_parallel: bool = False):
        from tpu_rvc_torch.audio.io import save_wav

        vc, _ = self._get_vc(model_name)
        index = None
        if file_index and os.path.exists(file_index):
            from tpu_rvc_torch.retrieval.index import FeatureIndex
            index = FeatureIndex.load(file_index)
        manual_f0 = None
        if f0_file and os.path.exists(f0_file):
            # comma-separated "time_s,f0_hz" rows (the reference pipeline's
            # f0_file parsing, infer/modules/vc/pipeline.py:244-253)
            with open(f0_file) as f:
                rows = [line.split(",") for line in
                        f.read().strip().split("\n") if line.strip()]
            manual_f0 = [[float(x) for x in r] for r in rows]
        info, (sr, audio) = vc.vc_single(
            sid, input_audio_path, f0_up_key, f0_method, index, index_rate,
            filter_radius, resample_sr, rms_mix_rate, protect,
            f0_file=manual_f0, chunk_parallel=chunk_parallel)
        save_wav(output_path, audio, sr)
        return {"info": info, "sr": sr, "output": output_path}

    def infer_convert_batch(self, sid: int, input_dir: str, output_dir: str,
                            model_name: str = "", **kwargs):
        vc, _ = self._get_vc(model_name)
        index = None
        if kwargs.get("file_index") and os.path.exists(kwargs["file_index"]):
            from tpu_rvc_torch.retrieval.index import FeatureIndex
            index = FeatureIndex.load(kwargs.pop("file_index"))
        else:
            kwargs.pop("file_index", None)
        paths = [os.path.join(input_dir, n)
                 for n in sorted(os.listdir(input_dir))]
        report = vc.vc_multi(sid, paths, output_dir, index=index, **{
            k: v for k, v in kwargs.items()
            if k in ("f0_up_key", "f0_method", "index_rate", "filter_radius",
                     "resample_sr", "rms_mix_rate", "protect")})
        return {"report": report}

    # ---------------- uvr tab ----------------
    def uvr_convert(self, model_path: str, input_path: str,
                    ins_root: str = "opt_ins", vocal_root: str = "opt_voc",
                    agg: float = 10):
        from tpu_rvc_torch.audio.io import save_wav
        from tpu_rvc_torch.pipeline import uvr5

        sep = self._uvr.get((model_path, agg))
        if sep is not None:
            self._uvr.move_to_end((model_path, agg))
        else:
            sep = uvr5.load_separator(model_path, agg=agg,
                                      device=self.device)
            if not hasattr(sep, "_path_audio_") and \
                    self.device.type == "cuda":
                # the whole flow on the card: one upload, two int16 fetches
                sep = uvr5.DeviceSeparator(sep)
            self._uvr[(model_path, agg)] = sep
            while len(self._uvr) > self._uvr_capacity:
                self._uvr.popitem(last=False)  # the least recently used
        if hasattr(sep, "_path_audio_"):  # MDXNetDereverb
            sep._path_audio_(input_path, vocal_root, ins_root)
            return {"instrument": ins_root, "vocal": vocal_root}
        ins, voc, sr = sep.separate(input_path)
        os.makedirs(ins_root, exist_ok=True)
        os.makedirs(vocal_root, exist_ok=True)
        name = os.path.basename(input_path)
        ins_path = os.path.join(ins_root, f"instrument_{name}.wav")
        voc_path = os.path.join(vocal_root, f"vocal_{name}.wav")
        save_wav(ins_path, ins, sr)
        save_wav(voc_path, voc, sr)
        return {"instrument": ins_path, "vocal": voc_path}

    # ---------------- train tab ----------------
    def train_preprocess(self, trainset_dir: str, exp_dir: str,
                         sr: int = 48000, n_p: int = 8, per: float = 3.7):
        from tpu_rvc_torch.train.preprocess import preprocess_dataset
        preprocess_dataset(trainset_dir, sr, n_p, exp_dir, per)
        return {"status": "done", "exp_dir": exp_dir}

    def train_extract_f0_feature(self, exp_dir: str, version: str = "v2",
                                 if_f0: int = 1, f0_method: str = "rmvpe"):
        from tpu_rvc_torch.train.extract import extract_f0, extract_features
        logs = []
        if if_f0:
            logs += extract_f0(exp_dir, f0_method=f0_method,
                               rmvpe_root=self.rmvpe_root,
                               device=self.device)
        logs += extract_features(exp_dir, version=version,
                                 hubert_path=self.hubert_path,
                                 device=self.device)
        return {"status": "done", "logs": logs}

    def train_index(self, exp_dir: str, version: str = "v2",
                    name: str = "index"):
        import numpy as np
        from tpu_rvc_torch.retrieval.index import build_index
        feat_dir = os.path.join(
            exp_dir, "3_feature256" if version == "v1" else "3_feature768")
        feats = np.concatenate(
            [np.load(os.path.join(feat_dir, n))
             for n in sorted(os.listdir(feat_dir))], axis=0)
        idx = build_index(feats, version, device=self.device)
        out = os.path.join(exp_dir, f"added_{name}.tpuidx.npz")
        idx.save(out)
        return {"index": out, "rows": int(idx.vectors.shape[0])}

    def train_start(self, exp_dir: str, version: str = "v2", sr: int = 48000,
                    if_f0: int = 1, epochs: int = 20, batch_size: int = 4,
                    save_every: int = 5, pretrain_g: str = "",
                    pretrain_d: str = "", name: str = "model",
                    author: str = "", log_fn=None):
        import dataclasses
        from tpu_rvc_torch.core.config import hparams_for
        from tpu_rvc_torch.train.loop import run_training
        hp = hparams_for(version, sr)
        hp = dataclasses.replace(
            hp, train=dataclasses.replace(hp.train, batch_size=batch_size))
        metrics = run_training(exp_dir, hp, total_epochs=epochs,
                               if_f0=bool(if_f0), save_every_epoch=save_every,
                               pretrain_g=pretrain_g, pretrain_d=pretrain_d,
                               name=name, author=author, log_fn=log_fn,
                               device=self.device)
        return {"status": "done", "metrics": metrics}

    def train_start_all(self, exp_dir: str, trainset_dir: str,
                        version: str = "v2", sr: int = 48000,
                        if_f0: int = 1, f0_method: str = "rmvpe",
                        n_p: int = 8, per: float = 3.7, epochs: int = 20,
                        batch_size: int = 4, save_every: int = 5,
                        pretrain_g: str = "", pretrain_d: str = "",
                        name: str = "model", author: str = "", log_fn=None):
        """One-click training (reference train1key, web.py:600-688):
        preprocess -> f0 and feature extraction -> GAN training -> index."""
        log = log_fn or (lambda s: None)
        log("step 1/4: preprocess")
        steps = [self.train_preprocess(trainset_dir, exp_dir, sr, n_p, per)]
        log("step 2/4: f0/feature extraction")
        steps.append(self.train_extract_f0_feature(exp_dir, version, if_f0,
                                                   f0_method))
        log("step 3/4: training")
        steps.append(self.train_start(exp_dir, version, sr, if_f0, epochs,
                                      batch_size, save_every, pretrain_g,
                                      pretrain_d, name, author=author,
                                      log_fn=log_fn))
        log("step 4/4: index build")
        steps.append(self.train_index(exp_dir, version, name))
        return {"status": "done", "steps": steps}

    # ---------------- ckpt tab ----------------
    def ckpt_merge(self, path1: str, path2: str, alpha1: float, sr: str,
                   f0: int, info: str, name: str, version: str):
        from tpu_rvc_torch.ckpt.small_model import merge
        out = merge(path1, path2, alpha1, sr, f0, info, name, version)
        return {"output": out}

    def ckpt_modify(self, path: str, info: str, name: str = ""):
        from tpu_rvc_torch.ckpt.small_model import change_info
        return {"output": change_info(path, info, name)}

    def ckpt_show(self, path: str):
        """A model file's fields but its weights; arrays read as None."""
        import torch
        cpt = torch.load(path, map_location="cpu", weights_only=False)
        return {k: (v if not hasattr(v, "shape") else None)
                for k, v in cpt.items() if k != "weight"}

    def ckpt_extract(self, path: str, name: str, sr: str, if_f0: int,
                     info: str, version: str, author: str = ""):
        from tpu_rvc_torch.ckpt import small_model
        from tpu_rvc_torch.core.config import hparams_for
        hp = hparams_for(version, {"32k": 32000, "40k": 40000,
                                   "48k": 48000}[sr])
        out = small_model.extract_small_model(path, name, sr, if_f0, info,
                                              version, hp, author=author)
        return {"output": out}

    # ---------------- export tab ----------------
    def export_onnx(self, ckpt_path: str, onnx_path: str, frames: int = 200,
                    reference_layout: bool = False):
        """ONNX export endpoint (reference web.py:1519)."""
        from tpu_rvc_torch.ckpt.export import export_onnx
        export_onnx(ckpt_path, onnx_path, T=frames,
                    reference_layout=reference_layout, device=self.device)
        return {"output": onnx_path}

    # ---------------- log-tail streaming ----------------
    def stream_endpoint(self, endpoint: str, poll: float = 0.5, **kwargs):
        """Run endpoint `endpoint` in a worker thread, yielding the growing
        log text until it finishes: the role of the reference's
        subprocess-log-tail generators (web.py:141-162,185-199).  Endpoints
        that take log_fn stream their progress lines; the others stream a
        heartbeat, then the result.  The worker's kernels go to its own
        current stream, and the entry points it reaches set fp32 math
        themselves."""
        if endpoint not in ENDPOINTS:
            raise ValueError(f"unknown endpoint {endpoint}")
        fn = getattr(self, endpoint)
        lines: list = []
        done = threading.Event()
        res: dict = {}
        takes_log = "log_fn" in inspect.signature(fn).parameters

        def runner():
            try:
                if takes_log:
                    res["result"] = fn(log_fn=lines.append, **kwargs)
                else:
                    res["result"] = fn(**kwargs)
            except Exception:
                res["error"] = traceback.format_exc()
            finally:
                done.set()

        t = threading.Thread(target=runner, daemon=True)
        t0 = time.time()
        t.start()
        while not done.is_set():
            yield "\n".join(lines) if lines else \
                f"running {endpoint}... ({time.time() - t0:.0f}s)"
            done.wait(poll)
        t.join()
        if "error" in res:
            yield "\n".join(lines + [res["error"]])
        else:
            yield "\n".join(lines + [json.dumps(res["result"], default=str)])


ENDPOINTS = ("infer_convert", "infer_convert_batch", "uvr_convert",
             "train_preprocess", "train_extract_f0_feature", "train_index",
             "train_start", "train_start_all", "ckpt_merge", "ckpt_modify",
             "ckpt_show", "ckpt_extract", "export_onnx",
             "change_choices", "clean", "change_voice", "hash_similarity",
             "lookup_names", "lookup_indices", "lookup_uvr5_names")


def http_server(api: Api, host: str = "127.0.0.1", port: int = 7865):
    """The JSON-over-HTTP front end, bound and not yet serving: POST
    /api/<endpoint> with the keyword arguments as a JSON object gives
    {"ok": true, "result": ...} (200), a traceback (500) or 404 for a name
    not in ENDPOINTS; GET lists the endpoints.  Port 0 takes a free one
    (`server_address` says which)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            name = self.path.strip("/").removeprefix("api/")
            if name not in ENDPOINTS:
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                kwargs = json.loads(self.rfile.read(n) or b"{}")
                result = getattr(api, name)(**kwargs)
                body, code = json.dumps({"ok": True, "result": result}), 200
            except Exception:
                body, code = json.dumps({"ok": False,
                                         "error": traceback.format_exc()}), 500
            self._reply(code, body.encode())

        def do_GET(self):
            self._reply(200, json.dumps(
                {"endpoints": list(ENDPOINTS)}).encode())

        def log_message(self, *a):
            pass

    return HTTPServer((host, port), Handler)


def serve_http(api: Api, host: str = "127.0.0.1", port: int = 7865):
    srv = http_server(api, host, port)
    print(f"tpu_rvc_torch API listening on http://{host}:"
          f"{srv.server_address[1]} (POST /api/<endpoint>)")
    srv.serve_forever()


def serve_gradio(api: Api, host: str, port: int,
                 infer_only: bool = False):  # pragma: no cover - no gradio
    """Launch the gradio WebUI (layout in tpu_rvc_torch/apps/webui.py,
    mirroring reference web.py:690-1550; infer_only serves the reduced
    app, reference tools/web/infer-only.py role)."""
    import gradio as gr

    from tpu_rvc_torch.apps.webui import build_app, build_infer_only_app

    app = (build_infer_only_app(gr, api) if infer_only
           else build_app(gr, api))
    app.queue(max_size=1022).launch(server_name=host, server_port=port,
                                    max_threads=511)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_rvc_torch.apps.web",
                                description="tpu_rvc_torch web app")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7865)
    p.add_argument("--http-only", action="store_true",
                   help="skip gradio even if installed")
    p.add_argument("--infer-only", action="store_true",
                   help="serve only the inference surface "
                        "(reference tools/web/infer-only.py)")
    p.add_argument("--weight-root", default="assets/weights")
    p.add_argument("--index-root", default="logs")
    p.add_argument("--hubert", default="assets/hubert/hubert_base.pt")
    p.add_argument("--rmvpe-root", default="assets/rmvpe")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    api = Api(weight_root=args.weight_root, index_root=args.index_root,
              hubert_path=args.hubert, rmvpe_root=args.rmvpe_root,
              device=args.device)
    if not args.http_only:
        try:
            import gradio  # noqa: F401
        except ImportError:
            pass
        else:
            serve_gradio(api, args.host, args.port,
                         infer_only=args.infer_only)
            return
    serve_http(api, args.host, args.port)


if __name__ == "__main__":
    main()
