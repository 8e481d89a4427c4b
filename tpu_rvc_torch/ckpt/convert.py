"""Weights into the port's state_dicts.

The port's parameters carry the reference torch names and layouts, so:

* `synthesizer_state_from_reference(sd)` takes an RVC `.pth` `weight`
  dict as it is: legacy `weight_g`/`weight_v` and torch>=2.1
  `parametrizations.weight.original{0,1}` keys are normalised (as
  tpu_rvc/ckpt/convert.py:40 does) and weight norm is folded.
* `synthesizer_state_from_jax(params)` maps a tpu_rvc flax params tree
  (nested dicts of arrays, with or without weight norm) to the same
  state_dict: this package's own copy of the inverse of
  tpu_rvc/ckpt/convert.py:122 (conv kernels (K, in, out) -> (out, in, K),
  transposed-conv kernels un-flipped to (in, out, K), Linear transposed).
* `train_state_from_jax(g_params, d_params)` maps the JAX trainer's G and
  D trees (weight norm kept, enc_q included) to the state_dicts of the
  port's training G and its `MultiPeriodDiscriminator`: the inverse of
  tpu_rvc/ckpt/convert.py:122-225 and :349-427.
* `train_state_from_reference(sd)` takes a reference `G_*.pth`/`D_*.pth`
  `model` dict (weight norm kept) for the training modules, and
  `merge_partial` loads what of it fits (the warm start).
* `hubert_state_from_jax(params)` does the same for HuBERT (fairseq names).
* `rmvpe_state_from_jax(params)` does it for the RMVPE E2E tree (the
  reference `rmvpe.pt` names; BatchNorm stays folded as (scale, bias)):
  this package's own copy of the inverse of tpu_rvc/ckpt/rmvpe_loader.py:50.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def normalize_weight_norm_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """parametrizations.weight.original{0,1} -> weight_{g,v}."""
    out = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        k = k.replace("parametrizations.weight.original1", "weight_v")
        out[k] = v
    return out


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def fold_weight_norm(sd: Dict[str, Any], dim: int = 0) -> StateDict:
    """Replace every (X.weight_g, X.weight_v) pair by X.weight =
    g * v / ||v||, the norm over all axes but `dim` (torch weight_norm)."""
    out: StateDict = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[:-len(".weight_v")]
            g, vv = _tensor(sd[base + ".weight_g"]), _tensor(v)
            axes = [a for a in range(vv.dim()) if a != dim % vv.dim()]
            norm = torch.sqrt((vv * vv).sum(dim=axes, keepdim=True))
            out[base + ".weight"] = (g * vv / norm).contiguous()
        else:
            out[k] = _tensor(v)
    return out


def synthesizer_state_from_reference(sd: Dict[str, Any]) -> StateDict:
    """Reference small-model `weight` dict -> the port's Synthesizer
    state_dict (float32, weight norm folded, training-only enc_q dropped)."""
    sd = {k: v for k, v in normalize_weight_norm_keys(sd).items()
          if not k.startswith("enc_q.")}
    return fold_weight_norm(sd)


# --------------------------------------------------------------------------
# flax params -> reference names
# --------------------------------------------------------------------------


def _conv_back(tree, prefix: str, out: Dict[str, np.ndarray],
               transposed: bool = False) -> None:
    def t(a):  # (K, in, out) -> (out, in, K), or (in, out, K) un-flipped
        a = np.asarray(a, np.float32)
        if transposed:
            return np.ascontiguousarray(np.transpose(a, (1, 2, 0))[:, :, ::-1])
        return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))

    if "v" in tree:
        g = np.asarray(tree["g"], np.float32)
        out[f"{prefix}.weight_v"] = t(tree["v"])
        out[f"{prefix}.weight_g"] = (np.transpose(g, (1, 2, 0)) if transposed
                                     else np.transpose(g, (2, 1, 0)))
    else:
        out[f"{prefix}.weight"] = t(tree["kernel"])
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"], np.float32)


def _linear_back(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.asarray(tree["kernel"], np.float32).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"], np.float32)


def _wn_back(wn, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if "cond_layer" in wn:
        _conv_back(wn["cond_layer"], f"{prefix}.cond_layer", out)
    for m in range(sum(1 for k in wn if k.startswith("in_"))):
        _conv_back(wn[f"in_{m}"], f"{prefix}.in_layers.{m}", out)
        _conv_back(wn[f"res_skip_{m}"], f"{prefix}.res_skip_layers.{m}", out)


def synthesizer_state_from_jax(params: Dict[str, Any]) -> StateDict:
    """tpu_rvc Synthesizer params (the flax tree, optionally under
    "params") -> the port's inference state_dict (weight norm folded,
    enc_q dropped)."""
    return synthesizer_state_from_reference(_synthesizer_reference(params))


def _synthesizer_reference(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The flax tree -> the reference layout, numpy, weight norm as it is
    in the tree, enc_q included when the tree has it."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    enc_p = p["enc_p"]
    _linear_back(enc_p["emb_phone"], "enc_p.emb_phone", out)
    if "emb_pitch" in enc_p:
        out["enc_p.emb_pitch.weight"] = np.asarray(enc_p["emb_pitch"])
    enc = enc_p["encoder"]
    n_layers = sum(1 for k in enc if k.startswith("attn_"))
    for i in range(n_layers):
        a, pre = enc[f"attn_{i}"], f"enc_p.encoder.attn_layers.{i}"
        for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv_back(a[nm], f"{pre}.{nm}", out)
        out[f"{pre}.emb_rel_k"] = np.asarray(a["emb_rel_k"])
        out[f"{pre}.emb_rel_v"] = np.asarray(a["emb_rel_v"])
        for src, dst in ((f"norm1_{i}", f"norm_layers_1.{i}"),
                         (f"norm2_{i}", f"norm_layers_2.{i}")):
            out[f"enc_p.encoder.{dst}.gamma"] = np.asarray(enc[src]["gamma"])
            out[f"enc_p.encoder.{dst}.beta"] = np.asarray(enc[src]["beta"])
        for nm in ("conv_1", "conv_2"):
            _conv_back(enc[f"ffn_{i}"][nm],
                       f"enc_p.encoder.ffn_layers.{i}.{nm}", out)
    _conv_back(enc_p["proj"], "enc_p.proj", out)

    for i, name in enumerate(sorted(p["flow"])):
        tree, pre = p["flow"][name], f"flow.flows.{2 * i}"
        _conv_back(tree["pre"], f"{pre}.pre", out)
        _conv_back(tree["post"], f"{pre}.post", out)
        _wn_back(tree["enc"], f"{pre}.enc", out)

    dec = p["dec"]
    _conv_back(dec["conv_pre"], "dec.conv_pre", out)
    _conv_back(dec["conv_post"], "dec.conv_post", out)
    if "cond" in dec:
        _conv_back(dec["cond"], "dec.cond", out)
    n_ups = sum(1 for k in dec if k.startswith("up_"))
    n_k = sum(1 for k in dec if k.startswith("resblock_0_"))
    for i in range(n_ups):
        _conv_back(dec[f"up_{i}"], f"dec.ups.{i}", out, transposed=True)
        if f"noise_conv_{i}" in dec:
            _conv_back(dec[f"noise_conv_{i}"], f"dec.noise_convs.{i}", out)
        for j in range(n_k):
            rb, n = dec[f"resblock_{i}_{j}"], i * n_k + j
            if "c1_0" in rb:  # ResBlock1
                for m in range(sum(1 for k in rb if k.startswith("c1_"))):
                    _conv_back(rb[f"c1_{m}"], f"dec.resblocks.{n}.convs1.{m}",
                               out)
                    _conv_back(rb[f"c2_{m}"], f"dec.resblocks.{n}.convs2.{m}",
                               out)
            else:  # ResBlock2
                for m in range(len(rb)):
                    _conv_back(rb[f"c_{m}"], f"dec.resblocks.{n}.convs.{m}",
                               out)
    if "m_source" in dec:
        _linear_back(dec["m_source"]["l_linear"], "dec.m_source.l_linear", out)
    if "enc_q" in p:
        q = p["enc_q"]
        _conv_back(q["pre"], "enc_q.pre", out)
        _conv_back(q["proj"], "enc_q.proj", out)
        _wn_back(q["enc"], "enc_q.enc", out)
    out["emb_g.weight"] = np.asarray(p["emb_g"]["embedding"])
    return out


_V1_PERIODS = (2, 3, 5, 7, 11, 17)
_V2_PERIODS = (2, 3, 5, 7, 11, 17, 23, 37)


def discriminator_state_from_jax(params: Dict[str, Any],
                                 version: str = "v2") -> StateDict:
    """tpu_rvc MultiPeriodDiscriminator params -> the reference D layout
    (this package's copy of tpu_rvc/ckpt/convert.py:395-427): 2-D kernels
    (kh, kw, in, out) -> (out, in, kh, kw), g (1, 1, 1, out) -> (out, 1,
    1, 1); DiscriminatorS's (k, 1, in, out) -> Conv1d (out, in, k)."""
    p = params.get("params", params)
    periods = _V2_PERIODS if version == "v2" else _V1_PERIODS
    out: Dict[str, np.ndarray] = {}

    def put(tree, name, prefix, from_1d=False):
        g, v = (np.asarray(tree[f"{name}_{x}"], np.float32) for x in "gv")
        if from_1d:
            out[f"{prefix}.weight_g"] = np.transpose(g[0], (2, 0, 1))
            out[f"{prefix}.weight_v"] = np.transpose(v[:, 0], (2, 1, 0))
        else:
            out[f"{prefix}.weight_g"] = np.transpose(g, (3, 0, 1, 2))
            out[f"{prefix}.weight_v"] = np.transpose(v, (3, 2, 0, 1))
        out[f"{prefix}.bias"] = np.asarray(tree[f"{name}_bias"], np.float32)

    for i in range(6):
        put(p["disc_s"], f"conv_{i}", f"discriminators.0.convs.{i}", True)
    put(p["disc_s"], "conv_post", "discriminators.0.conv_post", True)
    for j, period in enumerate(periods, start=1):
        dp = p[f"disc_p{period}"]
        for i in range(5):
            put(dp, f"conv_{i}", f"discriminators.{j}.convs.{i}")
        put(dp, "conv_post", f"discriminators.{j}.conv_post")
    return {k: _tensor(v) for k, v in out.items()}


def train_state_from_jax(g_params: Dict[str, Any], d_params: Dict[str, Any],
                         version: str = "v2"):
    """The JAX trainer's (G, D) parameter trees (numpy, weight norm
    unfolded, enc_q included) -> (G, D) state_dicts of the port's training
    modules (`make_synthesizer(train=True)`, `MultiPeriodDiscriminator`)."""
    g = {k: _tensor(v) for k, v in _synthesizer_reference(g_params).items()}
    return g, discriminator_state_from_jax(d_params, version)


def train_state_from_reference(sd: Dict[str, Any]) -> StateDict:
    """A reference training checkpoint's `model` dict -> float32 tensors
    under the port's names (weight norm kept, legacy and torch>=2.1 keys
    both accepted)."""
    return {k: _tensor(v) for k, v in normalize_weight_norm_keys(sd).items()}


def merge_partial(module: torch.nn.Module, sd: Dict[str, Any]) -> int:
    """Load the tensors of `sd` whose name and shape match the module's,
    leave the rest as they are (reference utils.py:33-73 semantics, the
    warm start from pretrained G/D): returns how many matched."""
    own = module.state_dict()
    hits = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    with torch.no_grad():
        for k, v in hits.items():
            own[k].copy_(torch.as_tensor(v))
    return len(hits)


def hubert_state_from_jax(params: Dict[str, Any]) -> StateDict:
    """tpu_rvc Hubert params -> the port's HuBERT state_dict (fairseq
    names; the positional conv's weight norm folded)."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    fe = p["feature_extractor"]
    n_conv = sum(1 for k in fe if k.startswith("conv_"))
    for i in range(n_conv):
        out[f"feature_extractor.conv_layers.{i}.0.weight"] = np.transpose(
            np.asarray(fe[f"conv_{i}"]), (2, 1, 0))
    out["feature_extractor.conv_layers.0.2.weight"] = fe["gn_scale"]
    out["feature_extractor.conv_layers.0.2.bias"] = fe["gn_bias"]
    out["layer_norm.weight"] = p["layer_norm_pre"]["scale"]
    out["layer_norm.bias"] = p["layer_norm_pre"]["bias"]
    out["post_extract_proj.weight"] = np.asarray(p["post_extract_w"]).T
    out["post_extract_proj.bias"] = p["post_extract_b"]
    vk = np.asarray(p["pos_conv_v"], np.float32)          # (K, in/g, out)
    gk = np.asarray(p["pos_conv_g"], np.float32)          # (K, 1, 1)
    wk = gk * vk / np.sqrt((vk * vk).sum(axis=(1, 2), keepdims=True))
    out["encoder.pos_conv.0.weight"] = np.transpose(wk, (2, 1, 0))
    out["encoder.pos_conv.0.bias"] = p["pos_conv_b"]
    out["encoder.layer_norm.weight"] = p["encoder_layer_norm"]["scale"]
    out["encoder.layer_norm.bias"] = p["encoder_layer_norm"]["bias"]
    n_layers = sum(1 for k in p if k.startswith("layer_") and
                   k[len("layer_"):].isdigit())
    for i in range(n_layers):
        L, pre = p[f"layer_{i}"], f"encoder.layers.{i}"
        sa = L["self_attn"]
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
            out[f"{pre}.self_attn.{dst}.weight"] = np.asarray(sa[f"{src}_w"]).T
            out[f"{pre}.self_attn.{dst}.bias"] = sa[f"{src}_b"]
        for nm in ("self_attn_layer_norm", "final_layer_norm"):
            out[f"{pre}.{nm}.weight"] = L[nm]["scale"]
            out[f"{pre}.{nm}.bias"] = L[nm]["bias"]
        for nm in ("fc1", "fc2"):
            out[f"{pre}.{nm}.weight"] = np.asarray(L[f"{nm}_w"]).T
            out[f"{pre}.{nm}.bias"] = L[f"{nm}_b"]
    if "final_proj_w" in p:
        out["final_proj.weight"] = np.asarray(p["final_proj_w"]).T
        out["final_proj.bias"] = p["final_proj_b"]
    return {k: _tensor(v) for k, v in out.items()}


def rmvpe_state_from_jax(params: Dict[str, Any]) -> StateDict:
    """tpu_rvc E2E params -> the port's E2E state_dict.  2-D conv kernels
    (kh, kw, in, out) -> (out, in, kh, kw); the transposed conv's, which
    the JAX side keeps spatially flipped, -> (in, out, kh, kw) un-flipped;
    GRU and Linear matrices transposed."""
    p = params.get("params", params)
    out: Dict[str, np.ndarray] = {}

    def conv(w):
        return np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))

    def bn(tree, prefix):
        out[f"{prefix}.scale"] = tree["scale"]
        out[f"{prefix}.bias"] = tree["bias"]

    def conv_block_res(tree, prefix):
        out[f"{prefix}.conv.0.weight"] = conv(tree["conv0_w"])
        bn(tree["bn0"], f"{prefix}.conv.1")
        out[f"{prefix}.conv.3.weight"] = conv(tree["conv1_w"])
        bn(tree["bn1"], f"{prefix}.conv.4")
        if "shortcut_w" in tree:
            out[f"{prefix}.shortcut.weight"] = conv(tree["shortcut_w"])
            out[f"{prefix}.shortcut.bias"] = tree["shortcut_b"]

    def blocks(tree, prefix):
        for j in range(sum(1 for k in tree if k.startswith("block_"))):
            conv_block_res(tree[f"block_{j}"], f"{prefix}.{j}")

    unet = p["unet"]
    bn(unet["in_bn"], "unet.encoder.bn")
    for name, tree in unet.items():
        kind, _, i = name.partition("_")
        if kind == "enc":
            blocks(tree, f"unet.encoder.layers.{i}.conv")
        elif kind == "inter":
            blocks(tree, f"unet.intermediate.layers.{i}.conv")
        elif kind == "dec":
            d = f"unet.decoder.layers.{i}"
            up = np.asarray(tree["up_w"], np.float32)[::-1, ::-1]
            out[f"{d}.conv1.0.weight"] = np.transpose(up, (2, 3, 0, 1))
            bn(tree["up_bn"], f"{d}.conv1.1")
            blocks(tree, f"{d}.conv2")
    out["cnn.weight"] = conv(p["cnn_w"])
    out["cnn.bias"] = p["cnn_b"]
    for sfx_t, sfx_j in (("", ""), ("_reverse", "_rev")):
        g = p["gru"]
        out[f"fc.0.gru.weight_ih_l0{sfx_t}"] = np.asarray(g[f"wi{sfx_j}"]).T
        out[f"fc.0.gru.weight_hh_l0{sfx_t}"] = np.asarray(g[f"wh{sfx_j}"]).T
        out[f"fc.0.gru.bias_ih_l0{sfx_t}"] = g[f"bi{sfx_j}"]
        out[f"fc.0.gru.bias_hh_l0{sfx_t}"] = g[f"bh{sfx_j}"]
    out["fc.1.weight"] = np.asarray(p["fc_w"]).T
    out["fc.1.bias"] = p["fc_b"]
    return {k: _tensor(v) for k, v in out.items()}
