"""The web app's gradio layout (port of apps/webui.py; reference
web.py:690-1550).

`build_app(gr, api)` builds the tabbed Blocks app: Model Inference
(single and batch sub-tabs with the voice and index pickers and refresh),
UVR5 separation, Train (the three steps with log-tail streaming
generators), ckpt Processing (compare, fusion, modify, view, extract),
Export Onnx and FAQ, against the `Api` of tpu_rvc_torch/apps/web.py.
`build_infer_only_app(gr, api)` is the inference page alone.

The gradio module comes in as `gr`, so the layout is built and driven in
tests with a recording stub where gradio is not installed: every control
is an object, every `.click`/`.change` binding carries the reference's
`api_name`, and the bound functions are plain callables.  The tabs,
controls, bindings and i18n keys are the JAX app's, one for one.

Reference layout (file:line in the reference's web.py):
  - voice dropdown, refresh and clean: 700-731
  - single inference controls: 735-846;  batch: 847-1001
  - uvr tab: 1002-1065
  - train steps 1-3: 1066-1309 (log streaming generators 141-162)
  - ckpt compare/fusion/modify/view/extract: 1311-1520
  - onnx export: 1522-1537; FAQ tab: 1539-1550
"""

from __future__ import annotations

import os

from tpu_rvc_torch.utils.i18n import I18nAuto

i18n = I18nAuto()

SR_DICT = {"32k": 32000, "40k": 40000, "48k": 48000}

F0_METHODS = ["pm", "dio", "harvest", "crepe", "rmvpe", "fcpe"]

# the checkout holding the package: the FAQ is docs/en/faq.md there
REPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..")


def get_pretrained_models(path_str: str, f0_str: str, sr2: str,
                          root: str = "assets") -> tuple:
    """Pretrained G/D paths per version/f0/sr (reference web.py:300-333),
    returning "" for combinations whose files are absent."""
    g = os.path.join(root, f"pretrained{path_str}", f"{f0_str}G{sr2}.pth")
    d = os.path.join(root, f"pretrained{path_str}", f"{f0_str}D{sr2}.pth")
    return (g if os.path.exists(g) else "", d if os.path.exists(d) else "")


def build_app(gr, api, *, faq_path: str | None = None):
    """Construct the Blocks app; returns it (caller launches)."""
    names = [""] + api.lookup_names()
    index_paths = [""] + api.lookup_indices()
    uvr5_names = api.lookup_uvr5_names()

    # ---- backend adapters (UI value mapping -> Api kwargs) ----
    def ui_change_choices():
        c = api.change_choices()
        return ({"choices": sorted(c["names"]), "__type__": "update"},
                {"choices": sorted(c["indices"]), "__type__": "update"})

    def ui_clean():
        return api.clean()

    def ui_change_voice(model_name, protect0, protect1, idx2, idx4):
        m = api.change_voice(model_name)
        n_spk = max(int(m.get("n_spk", 1)) - 1, 0)
        spk_upd = {"maximum": n_spk, "value": 0, "__type__": "update",
                   "visible": bool(model_name)}
        prot = {"visible": bool(m.get("if_f0", 1)), "__type__": "update"}
        return (spk_upd, {**prot, "value": protect0},
                {**prot, "value": protect1},
                {"value": idx2, "__type__": "update"},
                {"value": idx4, "__type__": "update"},
                m.get("info", ""))

    def ui_convert(spk, input_path, transpose, f0_file, method, idx_file,
                   idx_drop, index_rate, filter_radius, resample_sr,
                   rms_mix_rate, protect, model_name):
        out_path = os.path.join("opt", "webui_out.wav")
        os.makedirs("opt", exist_ok=True)
        try:
            idx_file = getattr(idx_file, "name", idx_file)  # gr.File unwrap
            f0_file = getattr(f0_file, "name", f0_file)
            r = api.infer_convert(
                int(spk or 0), input_path, int(transpose or 0), method,
                idx_file or idx_drop or "", float(index_rate),
                int(filter_radius), int(resample_sr), float(rms_mix_rate),
                float(protect), model_name=model_name,
                output_path=out_path, f0_file=f0_file or None)
            return r["info"], r["output"]
        except Exception as e:
            return f"error: {e}", None

    def ui_convert_batch(spk, dir_input, opt_input, files, transpose,
                         method, idx_file, idx_drop, index_rate,
                         filter_radius, resample_sr, rms_mix_rate, protect,
                         fmt, model_name):
        try:
            src = dir_input if dir_input and os.path.isdir(dir_input) else None
            if src is None and files:
                # gradio file objects or plain paths
                src_dir = os.path.join("opt", "_batch_in")
                os.makedirs(src_dir, exist_ok=True)
                import shutil
                for f in files:
                    p = getattr(f, "name", f)
                    shutil.copy(p, src_dir)
                src = src_dir
            idx_file = getattr(idx_file, "name", idx_file)  # gr.File unwrap
            r = api.infer_convert_batch(
                int(spk or 0), src, opt_input or "opt",
                model_name=model_name, f0_up_key=int(transpose or 0),
                f0_method=method, file_index=idx_file or idx_drop or "",
                index_rate=float(index_rate),
                filter_radius=int(filter_radius),
                resample_sr=int(resample_sr),
                rms_mix_rate=float(rms_mix_rate), protect=float(protect))
            return "\n".join(r["report"]) if isinstance(r.get("report"), list) \
                else str(r)
        except Exception as e:
            return f"error: {e}"

    def ui_uvr(model_name, dir_wav, opt_vocal, wav_files, opt_ins, agg, fmt):
        paths = []
        if dir_wav and os.path.isdir(dir_wav):
            paths = [os.path.join(dir_wav, n)
                     for n in sorted(os.listdir(dir_wav))]
        elif wav_files:
            paths = [getattr(f, "name", f) for f in wav_files]
        logs = []
        if "onnx" in model_name:
            # MDX-Net entries are listed without a .pth suffix and
            # resolve to a directory holding the onnx graph (reference
            # uvr5/modules.py:27 routes onnx_dereverb_By_FoxJoy to
            # MDXNetDereverb)
            model_path = os.path.join(api.uvr5_root, model_name)
        else:
            model_path = os.path.join(api.uvr5_root, f"{model_name}.pth")
            if not os.path.exists(model_path):
                model_path = os.path.join(api.uvr5_root, model_name)
        for p in paths:
            try:
                r = api.uvr_convert(model_path, p, ins_root=opt_ins,
                                    vocal_root=opt_vocal, agg=float(agg))
                logs.append(f"{os.path.basename(p)} -> Success "
                            f"({r.get('vocal')}, {r.get('instrument')})")
            except Exception as e:
                logs.append(f"{os.path.basename(p)} -> {e}")
        return "\n".join(logs) or "no input files"

    # train-step streaming generators (reference web.py:141-162 pattern)
    def ui_train_preprocess(trainset_dir, exp_name, sr2, n_p):
        yield from api.stream_endpoint(
            "train_preprocess", trainset_dir=trainset_dir,
            exp_dir=os.path.join("logs", exp_name), sr=SR_DICT[sr2],
            n_p=int(n_p))

    def ui_train_extract(n_p, method, if_f0, exp_name, version):
        yield from api.stream_endpoint(
            "train_extract_f0_feature", exp_dir=os.path.join("logs", exp_name),
            version=version, if_f0=int(if_f0 == i18n("Yes")),
            f0_method=method)

    def ui_train_start(exp_name, sr2, if_f0, spk_id, save_epoch, total_epoch,
                       batch_size, if_save_latest, pretrain_g, pretrain_d,
                       gpus, if_cache, if_save_every, version, author):
        yield from api.stream_endpoint(
            "train_start", exp_dir=os.path.join("logs", exp_name),
            version=version, sr=SR_DICT[sr2],
            if_f0=int(if_f0 == i18n("Yes")), epochs=int(total_epoch),
            batch_size=int(batch_size), save_every=int(save_epoch),
            pretrain_g=pretrain_g, pretrain_d=pretrain_d, name=exp_name,
            author=author)

    def ui_train_index(exp_name, version):
        yield from api.stream_endpoint(
            "train_index", exp_dir=os.path.join("logs", exp_name),
            version=version, name=exp_name)

    def ui_train_all(exp_name, sr2, if_f0, trainset_dir, spk_id, n_p, method,
                     save_epoch, total_epoch, batch_size, if_save_latest,
                     pretrain_g, pretrain_d, gpus, if_cache, if_save_every,
                     version, author):
        yield from api.stream_endpoint(
            "train_start_all", exp_dir=os.path.join("logs", exp_name),
            trainset_dir=trainset_dir, version=version, sr=SR_DICT[sr2],
            if_f0=int(if_f0 == i18n("Yes")), f0_method=method,
            n_p=int(n_p), epochs=int(total_epoch),
            batch_size=int(batch_size), save_every=int(save_epoch),
            pretrain_g=pretrain_g, pretrain_d=pretrain_d, name=exp_name,
            author=author)

    def ui_ckpt_merge(a, b, alpha, sr, f0, info, name, version):
        try:
            r = api.ckpt_merge(a, b, float(alpha), sr,
                               int(f0 == i18n("Yes")), info, name, version)
            return r["output"]
        except Exception as e:
            return f"error: {e}"

    def ui_ckpt_modify(path, info, name):
        try:
            return api.ckpt_modify(path, info, name)["output"]
        except Exception as e:
            return f"error: {e}"

    def ui_ckpt_show(f):
        try:
            return str(api.ckpt_show(getattr(f, "name", f)))
        except Exception as e:
            return f"error: {e}"

    def ui_ckpt_extract(path, name, author, sr, if_f0, info, version):
        try:
            return api.ckpt_extract(path, name, sr, int(if_f0 == "1"),
                                    info, version, author=author)["output"]
        except Exception as e:
            return f"error: {e}"

    def ui_change_info(ckpt_path):
        """Pre-fill sr/f0/version from a G_*.pth (reference change_info_
        web.py:674-688)."""
        try:
            meta = api.ckpt_show(ckpt_path)
            sr = meta.get("sr", "48k")
            f0 = str(int(meta.get("f0", 1)))
            version = meta.get("version", "v2")
            return sr, f0, version
        except Exception:
            return "48k", "1", "v2"

    def ui_hash_similarity(id_a, id_b):
        r = api.hash_similarity(id_a, id_b)
        return (str(r["similarity"]) if r.get("similarity") is not None
                else r.get("error", ""))

    def ui_export_onnx(ckpt_dir, onnx_dir):
        try:
            return api.export_onnx(ckpt_dir, onnx_dir)["output"]
        except Exception as e:
            return f"error: {e}"

    # ------------------------------------------------------------------
    # layout
    # ------------------------------------------------------------------
    with gr.Blocks(title="tpu_rvc_torch WebUI") as app:
        gr.Markdown("## tpu_rvc_torch — Retrieval-based Voice Conversion")
        with gr.Tabs():
            # ======================= Model Inference =====================
            with gr.TabItem(i18n("Model Inference")):
                with gr.Row():
                    sid0 = gr.Dropdown(label=i18n("Inferencing voice"),
                                       choices=sorted(names))
                    with gr.Column():
                        refresh_button = gr.Button(
                            i18n("Refresh voice list and index path"),
                            variant="primary")
                        clean_button = gr.Button(
                            i18n("Unload model to save GPU memory"),
                            variant="primary")
                    spk_item = gr.Slider(minimum=0, maximum=2333, step=1,
                                         label=i18n("Select Speaker/Singer ID"),
                                         value=0, visible=False,
                                         interactive=True)
                    clean_button.click(fn=ui_clean, inputs=[], outputs=[sid0],
                                       api_name="infer_clean")
                modelinfo = gr.Textbox(label=i18n("Model info"), max_lines=8)
                with gr.TabItem(i18n("Single inference")):
                    with gr.Row():
                        with gr.Column():
                            vc_transform0 = gr.Number(
                                label=i18n("Transpose"), value=0)
                            input_audio0 = gr.Audio(
                                label=i18n("The audio file to be processed"),
                                type="filepath")
                            file_index2 = gr.Dropdown(
                                label=i18n("Auto-detect index path and select "
                                           "from the dropdown"),
                                choices=sorted(index_paths),
                                interactive=True)
                            file_index1 = gr.File(
                                label=i18n("Path to the feature index file"))
                        with gr.Column():
                            f0method0 = gr.Radio(
                                label=i18n("Select the pitch extraction "
                                           "algorithm"),
                                choices=list(F0_METHODS), value="rmvpe",
                                interactive=True)
                            resample_sr0 = gr.Slider(
                                minimum=0, maximum=48000, step=1, value=0,
                                label=i18n("Resample the output audio"),
                                interactive=True)
                            rms_mix_rate0 = gr.Slider(
                                minimum=0, maximum=1, value=0.25,
                                label=i18n("Volume envelope scaling"),
                                interactive=True)
                            protect0 = gr.Slider(
                                minimum=0, maximum=0.5, value=0.33, step=0.01,
                                label=i18n("Protect voiceless consonants"),
                                interactive=True)
                            filter_radius0 = gr.Slider(
                                minimum=0, maximum=7, value=3, step=1,
                                label=i18n("Median filter radius"),
                                interactive=True)
                            index_rate1 = gr.Slider(
                                minimum=0, maximum=1, value=0.75,
                                label=i18n("Feature searching ratio"),
                                interactive=True)
                            f0_file = gr.File(
                                label=i18n("F0 curve file (optional)"),
                                visible=False)
                            but0 = gr.Button(i18n("Convert"),
                                             variant="primary")
                            vc_output2 = gr.Audio(
                                label=i18n("Export audio"))
                            refresh_button.click(
                                fn=ui_change_choices, inputs=[],
                                outputs=[sid0, file_index2],
                                api_name="infer_refresh")
                    vc_output1 = gr.Textbox(
                        label=i18n("Output information"))
                    but0.click(
                        ui_convert,
                        [spk_item, input_audio0, vc_transform0, f0_file,
                         f0method0, file_index1, file_index2, index_rate1,
                         filter_radius0, resample_sr0, rms_mix_rate0,
                         protect0, sid0],
                        [vc_output1, vc_output2], api_name="infer_convert")
                with gr.TabItem(i18n("Batch inference")):
                    with gr.Row():
                        with gr.Column():
                            vc_transform1 = gr.Number(
                                label=i18n("Transpose"), value=0)
                            dir_input = gr.Textbox(
                                label=i18n("Enter the path of the audio "
                                           "folder to be processed"))
                            inputs = gr.File(
                                file_count="multiple",
                                label=i18n("Multiple audio files can also be "
                                           "imported"))
                            opt_input = gr.Textbox(
                                label=i18n("Specify output folder"),
                                value="opt")
                            file_index4 = gr.Dropdown(
                                label=i18n("Auto-detect index path and select "
                                           "from the dropdown"),
                                choices=sorted(index_paths),
                                interactive=True)
                            file_index3 = gr.File(
                                label=i18n("Path to the feature index file"))
                            refresh_button.click(
                                fn=lambda: ui_change_choices()[1],
                                inputs=[], outputs=[file_index4],
                                api_name="infer_refresh_batch")
                        with gr.Column():
                            f0method1 = gr.Radio(
                                label=i18n("Select the pitch extraction "
                                           "algorithm"),
                                choices=list(F0_METHODS), value="rmvpe",
                                interactive=True)
                            resample_sr1 = gr.Slider(
                                minimum=0, maximum=48000, step=1, value=0,
                                label=i18n("Resample the output audio"),
                                interactive=True)
                            rms_mix_rate1 = gr.Slider(
                                minimum=0, maximum=1, value=1,
                                label=i18n("Volume envelope scaling"),
                                interactive=True)
                            protect1 = gr.Slider(
                                minimum=0, maximum=0.5, value=0.33, step=0.01,
                                label=i18n("Protect voiceless consonants"),
                                interactive=True)
                            filter_radius1 = gr.Slider(
                                minimum=0, maximum=7, value=3, step=1,
                                label=i18n("Median filter radius"),
                                interactive=True)
                            index_rate2 = gr.Slider(
                                minimum=0, maximum=1, value=1,
                                label=i18n("Feature searching ratio"),
                                interactive=True)
                            format1 = gr.Radio(
                                label=i18n("Export file format"),
                                choices=["wav", "flac", "mp3", "m4a"],
                                value="wav", interactive=True)
                            but1 = gr.Button(i18n("Convert"),
                                             variant="primary")
                            vc_output3 = gr.Textbox(
                                label=i18n("Output information"))
                    but1.click(
                        ui_convert_batch,
                        [spk_item, dir_input, opt_input, inputs,
                         vc_transform1, f0method1, file_index3, file_index4,
                         index_rate2, filter_radius1, resample_sr1,
                         rms_mix_rate1, protect1, format1, sid0],
                        [vc_output3], api_name="infer_convert_batch")
                    sid0.change(
                        fn=ui_change_voice,
                        inputs=[sid0, protect0, protect1, file_index2,
                                file_index4],
                        outputs=[spk_item, protect0, protect1, file_index2,
                                 file_index4, modelinfo],
                        api_name="infer_change_voice")
            # ================== UVR5 separation ==========================
            with gr.TabItem(i18n("Vocals/Accompaniment Separation & "
                                 "Reverberation Removal")):
                with gr.Row():
                    with gr.Column():
                        dir_wav_input = gr.Textbox(
                            label=i18n("Enter the path of the audio folder "
                                       "to be processed"))
                        wav_inputs = gr.File(
                            file_count="multiple",
                            label=i18n("Multiple audio files can also be "
                                       "imported"))
                    with gr.Column():
                        model_choose = gr.Dropdown(label=i18n("Model"),
                                                   choices=uvr5_names)
                        agg = gr.Slider(minimum=0, maximum=20, step=1,
                                        value=10, label="agg",
                                        interactive=True, visible=False)
                        opt_vocal_root = gr.Textbox(
                            label=i18n("Specify the output folder for "
                                       "vocals"), value="opt")
                        opt_ins_root = gr.Textbox(
                            label=i18n("Specify the output folder for "
                                       "accompaniment"), value="opt")
                        format0 = gr.Radio(
                            label=i18n("Export file format"),
                            choices=["wav", "flac", "mp3", "m4a"],
                            value="flac", interactive=True)
                    but2 = gr.Button(i18n("Convert"), variant="primary")
                    vc_output4 = gr.Textbox(label=i18n("Output information"))
                    but2.click(
                        ui_uvr,
                        [model_choose, dir_wav_input, opt_vocal_root,
                         wav_inputs, opt_ins_root, agg, format0],
                        [vc_output4], api_name="uvr_convert")
            # ======================= Train ===============================
            with gr.TabItem(i18n("Train")):
                with gr.Row():
                    exp_dir1 = gr.Textbox(
                        label=i18n("Enter the experiment name"),
                        value="mi-test")
                    author = gr.Textbox(label=i18n("Model Author (Nullable)"))
                    np7 = gr.Slider(minimum=0, maximum=os.cpu_count() or 8,
                                    step=1, value=max((os.cpu_count() or 8)
                                                      * 2 // 3, 1),
                                    label=i18n("Number of CPU processes"),
                                    interactive=True)
                with gr.Row():
                    sr2 = gr.Radio(label=i18n("Target sample rate"),
                                   choices=["32k", "40k", "48k"],
                                   value="48k", interactive=True)
                    if_f0_3 = gr.Radio(
                        label=i18n("Whether the model has pitch guidance"),
                        choices=[i18n("Yes"), i18n("No")],
                        value=i18n("Yes"), interactive=True)
                    version19 = gr.Radio(label=i18n("Version"),
                                         choices=["v1", "v2"], value="v2",
                                         interactive=True)
                with gr.Row():
                    with gr.Column():
                        trainset_dir4 = gr.Textbox(
                            label=i18n("Enter the path of the training "
                                       "folder"))
                        spk_id5 = gr.Slider(minimum=0, maximum=4, step=1,
                                            value=0,
                                            label=i18n("Please specify the "
                                                       "speaker/singer ID"),
                                            interactive=True)
                        but1t = gr.Button(i18n("Process data"),
                                          variant="primary")
                    with gr.Column():
                        info1 = gr.Textbox(label=i18n("Output information"),
                                           value="")
                        but1t.click(ui_train_preprocess,
                                    [trainset_dir4, exp_dir1, sr2, np7],
                                    [info1], api_name="train_preprocess")
                with gr.Row():
                    with gr.Column():
                        f0method8 = gr.Radio(
                            label=i18n("Select the pitch extraction "
                                       "algorithm"),
                            choices=list(F0_METHODS), value="rmvpe",
                            interactive=True)
                    with gr.Column():
                        but2t = gr.Button(i18n("Feature extraction"),
                                          variant="primary")
                        info2 = gr.Textbox(label=i18n("Output information"),
                                           value="")
                    but2t.click(ui_train_extract,
                                [np7, f0method8, if_f0_3, exp_dir1,
                                 version19],
                                [info2], api_name="train_extract_f0_feature")
                with gr.Row():
                    with gr.Column():
                        save_epoch10 = gr.Slider(
                            minimum=1, maximum=50, step=1, value=5,
                            label=i18n("Save frequency (save_every_epoch)"),
                            interactive=True)
                        total_epoch11 = gr.Slider(
                            minimum=2, maximum=1000, step=1, value=20,
                            label=i18n("Total training epochs (total_epoch)"),
                            interactive=True)
                        batch_size12 = gr.Slider(
                            minimum=1, maximum=40, step=1, value=4,
                            label=i18n("Batch size per GPU"),
                            interactive=True)
                        if_save_latest13 = gr.Radio(
                            label=i18n("Save only the latest '.ckpt' file"),
                            choices=[i18n("Yes"), i18n("No")],
                            value=i18n("No"), interactive=True)
                        if_cache_gpu17 = gr.Radio(
                            label=i18n("Cache all training sets to GPU "
                                       "memory"),
                            choices=[i18n("Yes"), i18n("No")],
                            value=i18n("No"), interactive=True)
                        if_save_every_weights18 = gr.Radio(
                            label=i18n("Save a small final model at each "
                                       "save point"),
                            choices=[i18n("Yes"), i18n("No")],
                            value=i18n("No"), interactive=True)
                    with gr.Column():
                        pretrained_G14 = gr.Textbox(
                            label=i18n("Load pre-trained base model G path"),
                            value=get_pretrained_models("_v2", "f0", "48k")[0],
                            interactive=True)
                        pretrained_D15 = gr.Textbox(
                            label=i18n("Load pre-trained base model D path"),
                            value=get_pretrained_models("_v2", "f0", "48k")[1],
                            interactive=True)
                        # the JAX app's key, kept so that both packages
                        # share one set of locale files
                        gpus16 = gr.Textbox(
                            label=i18n("Device mesh (all visible TPU chips "
                                       "are used via data-parallel SPMD)"),
                            value="mesh", interactive=False)

                        def _sr_change(sr2v, if_f0v, ver):
                            pre = "_v2" if ver == "v2" else ""
                            f0s = "f0" if if_f0v == i18n("Yes") else ""
                            g, d = get_pretrained_models(pre, f0s, sr2v)
                            return ({"value": g, "__type__": "update"},
                                    {"value": d, "__type__": "update"})

                        sr2.change(_sr_change, [sr2, if_f0_3, version19],
                                   [pretrained_G14, pretrained_D15])
                        version19.change(
                            lambda s, f, v: _sr_change(s, f, v) +
                            ({"__type__": "update"},),
                            [sr2, if_f0_3, version19],
                            [pretrained_G14, pretrained_D15, sr2])
                        if_f0_3.change(
                            lambda f, s, v: ({"visible": f == i18n("Yes"),
                                              "__type__": "update"},) +
                            _sr_change(s, f, v),
                            [if_f0_3, sr2, version19],
                            [f0method8, pretrained_G14, pretrained_D15])
                        but3 = gr.Button(i18n("Train model"),
                                         variant="primary")
                        but4 = gr.Button(i18n("Train feature index"),
                                         variant="primary")
                        but5 = gr.Button(i18n("One-click training"),
                                         variant="primary")
                with gr.Row():
                    info3 = gr.Textbox(label=i18n("Output information"),
                                       value="")
                    but3.click(
                        ui_train_start,
                        [exp_dir1, sr2, if_f0_3, spk_id5, save_epoch10,
                         total_epoch11, batch_size12, if_save_latest13,
                         pretrained_G14, pretrained_D15, gpus16,
                         if_cache_gpu17, if_save_every_weights18, version19,
                         author],
                        [info3], api_name="train_start")
                    but4.click(ui_train_index, [exp_dir1, version19],
                               [info3], api_name="train_index")
                    but5.click(
                        ui_train_all,
                        [exp_dir1, sr2, if_f0_3, trainset_dir4, spk_id5,
                         np7, f0method8, save_epoch10, total_epoch11,
                         batch_size12, if_save_latest13, pretrained_G14,
                         pretrained_D15, gpus16, if_cache_gpu17,
                         if_save_every_weights18, version19, author],
                        [info3], api_name="train_start_all")
            # ==================== ckpt Processing ========================
            with gr.TabItem(i18n("ckpt Processing")):
                with gr.Row():
                    with gr.Column():
                        id_a = gr.Textbox(
                            label=i18n("ID of model A (long)"), value="")
                        id_b = gr.Textbox(
                            label=i18n("ID of model B (long)"), value="")
                    with gr.Column():
                        butmodelcmp = gr.Button(i18n("Calculate"),
                                                variant="primary")
                        infomodelcmp = gr.Textbox(
                            label=i18n("Similarity (from 0 to 1)"),
                            value="", max_lines=1)
                butmodelcmp.click(ui_hash_similarity, [id_a, id_b],
                                  [infomodelcmp], api_name="ckpt_compare")
                with gr.Row():
                    with gr.Column():
                        ckpt_a = gr.Textbox(label=i18n("Path to Model A"),
                                            value="", interactive=True)
                        ckpt_b = gr.Textbox(label=i18n("Path to Model B"),
                                            value="", interactive=True)
                        alpha_a = gr.Slider(
                            minimum=0, maximum=1, value=0.5,
                            label=i18n("Weight (w) for Model A"),
                            interactive=True)
                    with gr.Column():
                        sr_ = gr.Radio(label=i18n("Target sample rate"),
                                       choices=["32k", "40k", "48k"],
                                       value="48k", interactive=True)
                        if_f0_ = gr.Radio(
                            label=i18n("Whether the model has pitch "
                                       "guidance"),
                            choices=[i18n("Yes"), i18n("No")],
                            value=i18n("Yes"), interactive=True)
                        info__ = gr.Textbox(
                            label=i18n("Model information to be placed"),
                            value="", max_lines=8, interactive=True)
                    with gr.Column():
                        name_to_save0 = gr.Textbox(
                            label=i18n("Saved model name (without "
                                       "extension)"),
                            value="", max_lines=1, interactive=True)
                        version_2 = gr.Radio(
                            label=i18n("Model architecture version"),
                            choices=["v1", "v2"], value="v1",
                            interactive=True)
                        but6 = gr.Button(i18n("Fusion"), variant="primary")
                with gr.Row():
                    info4 = gr.Textbox(label=i18n("Output information"),
                                       value="")
                but6.click(ui_ckpt_merge,
                           [ckpt_a, ckpt_b, alpha_a, sr_, if_f0_, info__,
                            name_to_save0, version_2],
                           [info4], api_name="ckpt_merge")
                with gr.Row():
                    with gr.Column():
                        ckpt_path0 = gr.Textbox(label=i18n("Path to Model"),
                                                value="", interactive=True)
                        info_ = gr.Textbox(
                            label=i18n("Model information to be modified"),
                            value="", max_lines=8, interactive=True)
                        name_to_save1 = gr.Textbox(
                            label=i18n("Save file name"),
                            value="", max_lines=1, interactive=True)
                    with gr.Column():
                        but7 = gr.Button(i18n("Modify"), variant="primary")
                        info5 = gr.Textbox(label=i18n("Output information"),
                                           value="")
                but7.click(ui_ckpt_modify, [ckpt_path0, info_, name_to_save1],
                           [info5], api_name="ckpt_modify")
                with gr.Row():
                    with gr.Column():
                        ckpt_path1 = gr.File(label=i18n("Path to Model"))
                        but8 = gr.Button(i18n("View"), variant="primary")
                    with gr.Column():
                        info6 = gr.Textbox(label=i18n("Output information"),
                                           value="")
                but8.click(ui_ckpt_show, [ckpt_path1], [info6],
                           api_name="ckpt_show")
                with gr.Row():
                    with gr.Column():
                        ckpt_path2 = gr.Textbox(
                            label=i18n("Path to Model"), value="",
                            interactive=True)
                        save_name = gr.Textbox(label=i18n("Save name"),
                                               value="", interactive=True)
                        with gr.Row():
                            sr__ = gr.Radio(
                                label=i18n("Target sample rate"),
                                choices=["32k", "40k", "48k"],
                                value="48k", interactive=True)
                            if_f0__ = gr.Radio(
                                label=i18n("Whether the model has pitch "
                                           "guidance (1: yes, 0: no)"),
                                choices=["1", "0"], value="1",
                                interactive=True)
                            version_1 = gr.Radio(
                                label=i18n("Model architecture version"),
                                choices=["v1", "v2"], value="v2",
                                interactive=True)
                        info___ = gr.Textbox(
                            label=i18n("Model information to be placed"),
                            value="", max_lines=8, interactive=True)
                        extauthor = gr.Textbox(label=i18n("Model Author"),
                                               value="", max_lines=1,
                                               interactive=True)
                    with gr.Column():
                        but9 = gr.Button(i18n("Extract"), variant="primary")
                        info7 = gr.Textbox(label=i18n("Output information"),
                                           value="")
                        ckpt_path2.change(ui_change_info, [ckpt_path2],
                                          [sr__, if_f0__, version_1])
                but9.click(ui_ckpt_extract,
                           [ckpt_path2, save_name, extauthor, sr__, if_f0__,
                            info___, version_1],
                           [info7], api_name="ckpt_extract")
            # ====================== Export Onnx ==========================
            with gr.TabItem(i18n("Export Onnx")):
                with gr.Row():
                    ckpt_dir = gr.Textbox(label=i18n("RVC Model Path"),
                                          value="", interactive=True)
                with gr.Row():
                    onnx_dir = gr.Textbox(label=i18n("Onnx Export Path"),
                                          value="", interactive=True)
                with gr.Row():
                    infoOnnx = gr.Textbox(label="info")
                with gr.Row():
                    butOnnx = gr.Button(i18n("Export Onnx Model"),
                                        variant="primary")
                butOnnx.click(ui_export_onnx, [ckpt_dir, onnx_dir],
                              [infoOnnx], api_name="export_onnx")
            # ========================= FAQ ===============================
            with gr.TabItem(i18n("FAQ (Frequently Asked Questions)")):
                faq = faq_path or os.path.join(
                    REPO_ROOT, "docs", "en", "faq.md")
                if os.path.exists(faq):
                    gr.Markdown(open(faq, encoding="utf8").read())
                else:
                    gr.Markdown(i18n("FAQ (Frequently Asked Questions)"))
    return app


def build_infer_only_app(gr, api):
    """Inference-only Blocks app (reference tools/web/infer-only.py role):
    the Model Inference tab's single-inference surface and nothing else."""
    names = [""] + api.lookup_names()
    index_paths = [""] + api.lookup_indices()

    def ui_convert(model_name, spk, input_path, transpose, method, idx_drop,
                   index_rate, protect):
        out_path = os.path.join("opt", "webui_out.wav")
        os.makedirs("opt", exist_ok=True)
        try:
            r = api.infer_convert(
                int(spk or 0), input_path, int(transpose or 0), method,
                idx_drop or "", float(index_rate), 3, 0, 0.25,
                float(protect), model_name=model_name, output_path=out_path)
            return r["info"], r["output"]
        except Exception as e:
            return f"error: {e}", None

    with gr.Blocks(title="tpu_rvc_torch infer-only") as app:
        gr.Markdown("## tpu_rvc_torch — inference")
        sid0 = gr.Dropdown(label=i18n("Inferencing voice"),
                           choices=sorted(names))
        spk_item = gr.Slider(minimum=0, maximum=2333, step=1, value=0,
                             label=i18n("Select Speaker/Singer ID"))
        input_audio0 = gr.Audio(label=i18n("The audio file to be processed"),
                                type="filepath")
        vc_transform0 = gr.Number(label=i18n("Transpose"), value=0)
        f0method0 = gr.Radio(label=i18n("Select the pitch extraction "
                                        "algorithm"),
                             choices=list(F0_METHODS), value="rmvpe")
        file_index2 = gr.Dropdown(
            label=i18n("Auto-detect index path and select from the "
                       "dropdown"), choices=sorted(index_paths))
        index_rate1 = gr.Slider(minimum=0, maximum=1, value=0.75,
                                label=i18n("Feature searching ratio"))
        protect0 = gr.Slider(minimum=0, maximum=0.5, value=0.33, step=0.01,
                             label=i18n("Protect voiceless consonants"))
        but0 = gr.Button(i18n("Convert"), variant="primary")
        vc_output1 = gr.Textbox(label=i18n("Output information"))
        vc_output2 = gr.Audio(label=i18n("Export audio"))
        but0.click(ui_convert,
                   [sid0, spk_item, input_audio0, vc_transform0, f0method0,
                    file_index2, index_rate1, protect0],
                   [vc_output1, vc_output2], api_name="infer_convert")
    return app
