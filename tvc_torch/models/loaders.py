"""Published checkpoints into the port's models (port of
``tvc/models/loaders.py``).

The converters map HF ``CLIPModel`` and ``Qwen2ForCausalLM`` state dicts,
and diffusers ``UNet2DConditionModel`` / ``AutoencoderKL`` ones, onto the
flax layouts the JAX package's models take, leaf for leaf: the same
names, shapes and bits as the JAX converters give (numpy leaves).
``DeepseekV2ForCausalLM`` state dicts (the JAX package has no such model)
map onto the names of ``DeepseekV2Model``'s own tree. The
port keeps those layouts in its own trees (``params_from_jax``,
``qwen_params_from_jax``, ``module_tree_from_jax``), so the loaders build
the port's models from them directly. Point the loaders at a local
checkout (``$TVC_CLIP_WEIGHTS`` / ``$TVC_QWEN_WEIGHTS`` / ``$TVC_SD_WEIGHTS``
or an explicit path); nothing is fetched. A loader that finds no
checkout returns None.

Files: a directory of ``*.safetensors`` shards, read by the port's own
reader (``tvc_torch._safetensors``; floats come out as f32, BF16 too), or
``pytorch_model*.bin`` shards through ``torch.load(weights_only=True)``.

Stable Diffusion: the port's native UNet (``tvc_torch/models/sd.py``) is
another architecture; ``tvc_torch/models/sd_hf.py`` is the
diffusers-layout mirror the SD converters fill, strictly (missing or
extra keys raise). ``load_sd_weights`` builds a ``StableDiffusionModel``
from a ``runwayml/stable-diffusion-v1-5``-layout checkout (``unet/`` and
``vae/``). ``save_params`` / ``load_params`` persist any parameter tree
as ``flax.serialization.to_bytes`` msgpack (``tvc_torch._flax_msgpack``),
which the JAX package reads too.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

# ---------------------------------------------------------------------------
# state-dict IO
# ---------------------------------------------------------------------------


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch/safetensors checkpoint into a numpy dict."""
    p = Path(path)
    if p.is_dir():
        # HF layout: model.safetensors / pytorch_model.bin (possibly sharded)
        candidates = sorted(p.glob("*.safetensors")) or sorted(p.glob("pytorch_model*.bin"))
        if not candidates:
            raise FileNotFoundError(f"no checkpoint files under {p}")
        out: Dict[str, np.ndarray] = {}
        for c in candidates:
            out.update(load_state_dict(str(c)))
        return out
    if p.suffix == ".safetensors":
        from tvc_torch._safetensors import load_file

        return load_file(p)
    import torch

    sd = torch.load(str(p), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() for k, v in sd.items()}


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] -> flax kernel [in, out]."""
    return np.ascontiguousarray(w.T)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def _convert_clip_tower(sd: Dict[str, np.ndarray], prefix: str, layers: int) -> Dict[str, Any]:
    """Shared encoder-layer conversion for HF CLIP text/vision towers."""
    blocks: Dict[str, Any] = {}
    for i in range(layers):
        lp = f"{prefix}.encoder.layers.{i}"
        qkv_kernel = np.concatenate([_t(sd[f"{lp}.self_attn.{n}_proj.weight"]) for n in ("q", "k", "v")], axis=1)
        qkv_bias = np.concatenate([sd[f"{lp}.self_attn.{n}_proj.bias"] for n in ("q", "k", "v")])
        blocks[f"block_{i}"] = {
            "ln_1": {"scale": sd[f"{lp}.layer_norm1.weight"], "bias": sd[f"{lp}.layer_norm1.bias"]},
            "attn": {
                "qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
                "out": {
                    "kernel": _t(sd[f"{lp}.self_attn.out_proj.weight"]),
                    "bias": sd[f"{lp}.self_attn.out_proj.bias"],
                },
            },
            "ln_2": {"scale": sd[f"{lp}.layer_norm2.weight"], "bias": sd[f"{lp}.layer_norm2.bias"]},
            "mlp": {
                "fc": {"kernel": _t(sd[f"{lp}.mlp.fc1.weight"]), "bias": sd[f"{lp}.mlp.fc1.bias"]},
                "proj": {"kernel": _t(sd[f"{lp}.mlp.fc2.weight"]), "bias": sd[f"{lp}.mlp.fc2.bias"]},
            },
        }
    return blocks


def convert_clip_state_dict(sd: Dict[str, np.ndarray], config) -> Dict[str, Any]:
    """HF ``transformers.CLIPModel`` state dict -> the CLIP parameter tree
    (flax layout: Dense ``[in, out]``, the patch embedding HWIO)."""
    vp = "vision_model"
    tp = "text_model"
    patch = sd[f"{vp}.embeddings.patch_embedding.weight"]  # [W, 3, P, P] OIHW
    visual = {
        "patch_embed": {"kernel": np.transpose(patch, (2, 3, 1, 0))},  # HWIO
        "class_embedding": sd[f"{vp}.embeddings.class_embedding"],
        "positional_embedding": sd[f"{vp}.embeddings.position_embedding.weight"],
        "ln_pre": {
            "scale": sd[f"{vp}.pre_layrnorm.weight"],  # (sic - HF typo)
            "bias": sd[f"{vp}.pre_layrnorm.bias"],
        },
        "transformer": _convert_clip_tower(sd, vp, config.vision_layers),
        "ln_post": {"scale": sd[f"{vp}.post_layernorm.weight"], "bias": sd[f"{vp}.post_layernorm.bias"]},
        "proj": _t(sd["visual_projection.weight"]),
    }
    text = {
        "token_embedding": {"embedding": sd[f"{tp}.embeddings.token_embedding.weight"]},
        "positional_embedding": sd[f"{tp}.embeddings.position_embedding.weight"],
        "transformer": _convert_clip_tower(sd, tp, config.text_layers),
        "ln_final": {"scale": sd[f"{tp}.final_layer_norm.weight"], "bias": sd[f"{tp}.final_layer_norm.bias"]},
        "text_projection": _t(sd["text_projection.weight"]),
    }
    return {"visual": visual, "text": text, "logit_scale": sd["logit_scale"]}


def clip_state_dict_shapes(config, position_ids: bool = True) -> Dict[str, tuple]:
    """The names and shapes of an HF ``CLIPModel`` state dict at ``config``
    (``openai/clip-vit-base-patch32`` at ``CLIPConfig.vit_b32()``), the
    int64 ``position_ids`` buffers of the published files included when
    ``position_ids``."""
    c = config
    out: Dict[str, tuple] = {}

    def tower(prefix: str, width: int, layers: int) -> None:
        for i in range(layers):
            lp = f"{prefix}.encoder.layers.{i}"
            for n in ("k", "v", "q", "out"):
                out[f"{lp}.self_attn.{n}_proj.weight"] = (width, width)
                out[f"{lp}.self_attn.{n}_proj.bias"] = (width,)
            for n in ("layer_norm1", "layer_norm2"):
                out[f"{lp}.{n}.weight"] = out[f"{lp}.{n}.bias"] = (width,)
            out[f"{lp}.mlp.fc1.weight"], out[f"{lp}.mlp.fc1.bias"] = (4 * width, width), (4 * width,)
            out[f"{lp}.mlp.fc2.weight"], out[f"{lp}.mlp.fc2.bias"] = (width, 4 * width), (width,)

    Wt, Wv = c.text_width, c.vision_width
    n_pos = (c.image_size // c.patch_size) ** 2 + 1
    out["text_model.embeddings.token_embedding.weight"] = (c.vocab_size, Wt)
    out["text_model.embeddings.position_embedding.weight"] = (c.context_length, Wt)
    if position_ids:
        out["text_model.embeddings.position_ids"] = (1, c.context_length)
    tower("text_model", Wt, c.text_layers)
    out["text_model.final_layer_norm.weight"] = out["text_model.final_layer_norm.bias"] = (Wt,)
    out["vision_model.embeddings.class_embedding"] = (Wv,)
    out["vision_model.embeddings.patch_embedding.weight"] = (Wv, 3, c.patch_size, c.patch_size)
    out["vision_model.embeddings.position_embedding.weight"] = (n_pos, Wv)
    if position_ids:
        out["vision_model.embeddings.position_ids"] = (1, n_pos)
    out["vision_model.pre_layrnorm.weight"] = out["vision_model.pre_layrnorm.bias"] = (Wv,)
    tower("vision_model", Wv, c.vision_layers)
    out["vision_model.post_layernorm.weight"] = out["vision_model.post_layernorm.bias"] = (Wv,)
    out["visual_projection.weight"] = (c.embed_dim, Wv)
    out["text_projection.weight"] = (c.embed_dim, Wt)
    out["logit_scale"] = ()
    return out


def load_clip_weights(config=None, path: Optional[str] = None, device=None):
    """Build a CLIPModel with converted HF weights from ``path`` (or
    $TVC_CLIP_WEIGHTS), on the card unless ``device="cpu"``. Returns None
    if no checkpoint is available."""
    from tvc_torch._device import resolve_device
    from tvc_torch.models.clip import CLIPConfig, CLIPModel

    path = path or os.environ.get("TVC_CLIP_WEIGHTS")
    if not path or not Path(path).exists():
        return None
    device = resolve_device(device)
    config = config or CLIPConfig()
    sd = load_state_dict(path)
    params = convert_clip_state_dict(sd, config)
    model = CLIPModel(config, params=params, device=device)
    _warn_hash_tokenizer(model.tokenizer, "CLIP", "$TVC_CLIP_BPE")
    return model


def _warn_hash_tokenizer(tokenizer, what: str, env_hint: str) -> None:
    """Real weights + the hash-fallback tokenizer silently produce garbage
    embeddings: warn loudly, or hard-fail with $TVC_STRICT_TOKENIZER=1."""
    from tvc_torch.models.tokenizer import HashTokenizer

    if not isinstance(tokenizer, HashTokenizer):
        return
    msg = (
        f"{what} weights are REAL but the tokenizer is the semantically "
        f"meaningless hash fallback — text embeddings will be garbage. "
        f"Provide the vocab/merges files ({env_hint})."
    )
    if os.environ.get("TVC_STRICT_TOKENIZER"):
        raise RuntimeError(msg)
    import warnings

    warnings.warn(msg, stacklevel=3)


# ---------------------------------------------------------------------------
# Qwen2
# ---------------------------------------------------------------------------


def convert_qwen_state_dict(sd: Dict[str, np.ndarray], config) -> Dict[str, Any]:
    """HF ``Qwen2ForCausalLM`` state dict -> the QwenLM parameter tree."""
    params: Dict[str, Any] = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "ln_f": {"scale": sd["model.norm.weight"]},
    }
    for i in range(config.num_layers):
        lp = f"model.layers.{i}"
        attn = {
            n: {"kernel": _t(sd[f"{lp}.self_attn.{n}_proj.weight"]), "bias": sd[f"{lp}.self_attn.{n}_proj.bias"]}
            for n in ("q", "k", "v")
        }
        attn["o"] = {"kernel": _t(sd[f"{lp}.self_attn.o_proj.weight"])}
        params[f"layer_{i}"] = {
            "ln_attn": {"scale": sd[f"{lp}.input_layernorm.weight"]},
            "attn": attn,
            "ln_mlp": {"scale": sd[f"{lp}.post_attention_layernorm.weight"]},
            "mlp": {n: {"kernel": _t(sd[f"{lp}.mlp.{n}_proj.weight"])} for n in ("gate", "up", "down")},
        }
    if not config.tie_embeddings:
        params["lm_head"] = {"kernel": _t(sd["lm_head.weight"])}
    return params


def qwen_state_dict_shapes(config) -> Dict[str, tuple]:
    """The names and shapes of an HF ``Qwen2ForCausalLM`` state dict at
    ``config`` (``lm_head.weight`` only when the embeddings are untied, as
    the published tied checkpoints hold)."""
    c = config
    D, Dh = c.hidden_size, c.hidden_size // c.num_heads
    out: Dict[str, tuple] = {"model.embed_tokens.weight": (c.vocab_size, D)}
    for i in range(c.num_layers):
        lp = f"model.layers.{i}"
        for n, rows in (("q", c.num_heads * Dh), ("k", c.num_kv_heads * Dh), ("v", c.num_kv_heads * Dh)):
            out[f"{lp}.self_attn.{n}_proj.weight"], out[f"{lp}.self_attn.{n}_proj.bias"] = (rows, D), (rows,)
        out[f"{lp}.self_attn.o_proj.weight"] = (D, c.num_heads * Dh)
        out[f"{lp}.mlp.gate_proj.weight"] = out[f"{lp}.mlp.up_proj.weight"] = (c.intermediate_size, D)
        out[f"{lp}.mlp.down_proj.weight"] = (D, c.intermediate_size)
        out[f"{lp}.input_layernorm.weight"] = out[f"{lp}.post_attention_layernorm.weight"] = (D,)
    out["model.norm.weight"] = (D,)
    if not c.tie_embeddings:
        out["lm_head.weight"] = (c.vocab_size, D)
    return out


def load_qwen_weights(config=None, path: Optional[str] = None, device=None, **model_kwargs):
    """Build a QwenModel with converted HF weights from ``path`` (or
    $TVC_QWEN_WEIGHTS), on the card unless ``device="cpu"``;
    ``model_kwargs`` go to ``QwenModel`` (``cast_params_bf16``,
    ``max_new_tokens``, ...). Returns None if no checkpoint is available."""
    from tvc_torch._device import resolve_device
    from tvc_torch.models.qwen import QwenConfig, QwenModel, qwen_params_from_jax

    path = path or os.environ.get("TVC_QWEN_WEIGHTS")
    if not path or not Path(path).exists():
        return None
    device = resolve_device(device)
    config = config or QwenConfig()
    sd = load_state_dict(path)
    params = convert_qwen_state_dict(sd, config)
    del sd
    model = QwenModel(config, params=qwen_params_from_jax(params, config), device=device, **model_kwargs)
    _warn_hash_tokenizer(model.tokenizer, "Qwen", "$TVC_QWEN_TOKENIZER")
    return model


# ---------------------------------------------------------------------------
# DeepSeek-V2
# ---------------------------------------------------------------------------


def convert_deepseek_v2_state_dict(sd: Dict[str, np.ndarray], config) -> Dict[str, np.ndarray]:
    """HF ``DeepseekV2ForCausalLM`` state dict -> the flat names of
    ``DeepseekV2Model``'s tree: kernels ``[in, out]``, each gate and up
    projection merged along the output (gate first), the routed experts
    stacked ``[E, in, out]``, ``mlp.gate`` as the router."""
    c = config
    out: Dict[str, np.ndarray] = {
        "embed.embedding": sd["model.embed_tokens.weight"],
        "ln_f.scale": sd["model.norm.weight"],
        "lm_head.kernel": _t(sd["lm_head.weight"]),
    }

    def gate_up(prefix: str) -> np.ndarray:
        return np.concatenate([_t(sd[f"{prefix}.gate_proj.weight"]), _t(sd[f"{prefix}.up_proj.weight"])], axis=1)

    for i in range(c.num_layers):
        lp, b = f"model.layers.{i}", f"layer_{i}"
        a = f"{lp}.self_attn"
        out.update({
            f"{b}.ln_attn.scale": sd[f"{lp}.input_layernorm.weight"],
            f"{b}.ln_mlp.scale": sd[f"{lp}.post_attention_layernorm.weight"],
            f"{b}.attn.q.kernel": _t(sd[f"{a}.q_proj.weight"]),
            f"{b}.attn.kv_a.kernel": _t(sd[f"{a}.kv_a_proj_with_mqa.weight"]),
            f"{b}.attn.kv_norm.scale": sd[f"{a}.kv_a_layernorm.weight"],
            f"{b}.attn.kv_b.kernel": _t(sd[f"{a}.kv_b_proj.weight"]),
            f"{b}.attn.o.kernel": _t(sd[f"{a}.o_proj.weight"]),
        })
        m = f"{lp}.mlp"
        if i < c.first_k_dense:
            out[f"{b}.mlp.gate_up.kernel"] = gate_up(m)
            out[f"{b}.mlp.down.kernel"] = _t(sd[f"{m}.down_proj.weight"])
            continue
        E = c.n_routed_experts
        out[f"{b}.moe.router.kernel"] = _t(sd[f"{m}.gate.weight"])
        out[f"{b}.moe.experts.gate_up.kernel"] = np.stack([gate_up(f"{m}.experts.{e}") for e in range(E)])
        out[f"{b}.moe.experts.down.kernel"] = np.stack([_t(sd[f"{m}.experts.{e}.down_proj.weight"]) for e in range(E)])
        out[f"{b}.moe.shared.gate_up.kernel"] = gate_up(f"{m}.shared_experts")
        out[f"{b}.moe.shared.down.kernel"] = _t(sd[f"{m}.shared_experts.down_proj.weight"])
    return out


def deepseek_v2_state_dict_shapes(config) -> Dict[str, tuple]:
    """The names and shapes of an HF ``DeepseekV2ForCausalLM`` state dict at
    ``config`` (no q-LoRA)."""
    c = config
    H, nh, r = c.hidden_size, c.num_heads, c.kv_lora_rank
    out: Dict[str, tuple] = {"model.embed_tokens.weight": (c.vocab_size, H), "model.norm.weight": (H,),
                             "lm_head.weight": (c.vocab_size, H)}

    def mlp(prefix: str, width: int) -> None:
        out[f"{prefix}.gate_proj.weight"] = out[f"{prefix}.up_proj.weight"] = (width, H)
        out[f"{prefix}.down_proj.weight"] = (H, width)

    for i in range(c.num_layers):
        lp = f"model.layers.{i}"
        a = f"{lp}.self_attn"
        out[f"{lp}.input_layernorm.weight"] = out[f"{lp}.post_attention_layernorm.weight"] = (H,)
        out[f"{a}.q_proj.weight"] = (nh * (c.qk_nope_head_dim + c.qk_rope_head_dim), H)
        out[f"{a}.kv_a_proj_with_mqa.weight"] = (r + c.qk_rope_head_dim, H)
        out[f"{a}.kv_a_layernorm.weight"] = (r,)
        out[f"{a}.kv_b_proj.weight"] = (nh * (c.qk_nope_head_dim + c.v_head_dim), r)
        out[f"{a}.o_proj.weight"] = (H, nh * c.v_head_dim)
        if i < c.first_k_dense:
            mlp(f"{lp}.mlp", c.intermediate_size)
            continue
        out[f"{lp}.mlp.gate.weight"] = (c.n_routed_experts, H)
        for e in range(c.n_routed_experts):
            mlp(f"{lp}.mlp.experts.{e}", c.moe_intermediate_size)
        mlp(f"{lp}.mlp.shared_experts", c.moe_intermediate_size * c.n_shared_experts)
    return out


def load_deepseek_v2_weights(config=None, path: Optional[str] = None, device=None, **model_kwargs):
    """Build a DeepseekV2Model (w8) with converted HF weights from ``path``
    (or $TVC_DEEPSEEK_V2_WEIGHTS), on the card unless ``device="cpu"``;
    ``model_kwargs`` go to ``DeepseekV2Model``. Returns None if no
    checkpoint is available."""
    import torch

    from tvc_torch._device import resolve_device
    from tvc_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Model

    path = path or os.environ.get("TVC_DEEPSEEK_V2_WEIGHTS")
    if not path or not Path(path).exists():
        return None
    device = resolve_device(device)
    config = config or DeepseekV2Config.deepseek_v2_lite()
    params = convert_deepseek_v2_state_dict(load_state_dict(path), config)
    model = DeepseekV2Model(config, params={k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()},
                            device=device, **model_kwargs)
    _warn_hash_tokenizer(model.tokenizer, "DeepSeek-V2", "the bundled Qwen2 tokenizer files")
    return model


# ---------------------------------------------------------------------------
# Stable Diffusion (diffusers layout -> tvc_torch/models/sd_hf.py mirrors)
# ---------------------------------------------------------------------------

#: dotted diffusers sub-paths that are single modules in sd_hf.py
_SD_NAME_REWRITES = (
    ("ff.net.0.proj", "ff_net_0_proj"),
    ("ff.net.2", "ff_net_2"),
    ("to_out.0", "to_out_0"),
    ("downsamplers.0.conv", "downsamplers_0_conv"),
    ("upsamplers.0.conv", "upsamplers_0_conv"),
    ("time_embedding.linear_1", "time_embedding_linear_1"),
    ("time_embedding.linear_2", "time_embedding_linear_2"),
)

#: top-level block prefixes whose immediate child merges into one module name
_SD_BLOCK_CHILDREN = ("resnets_", "attentions_", "downsamplers_0_conv", "upsamplers_0_conv")


def _sd_flax_path(dotted: str) -> list:
    """diffusers param path (without .weight/.bias) -> flax tree path."""
    for pat, repl in _SD_NAME_REWRITES:
        dotted = dotted.replace(pat, repl)
    segs = []
    for s in dotted.split("."):
        if s.isdigit() and segs:
            segs[-1] = f"{segs[-1]}_{s}"
        else:
            segs.append(s)
    out: list = []
    for s in segs:
        if out and s.startswith(_SD_BLOCK_CHILDREN) and (
            out[-1] == "mid_block"
            or (
                out[-1].startswith(("down_blocks_", "up_blocks_"))
                and not any(c in out[-1] for c in _SD_BLOCK_CHILDREN)
            )
        ):
            out[-1] = f"{out[-1]}_{s}"
        else:
            out.append(s)
    return out


def _sd_leaf(name: str, w: np.ndarray):
    """(leaf param name, converted array) for a diffusers weight/bias."""
    if name == "bias":
        return "bias", w
    if w.ndim == 4:  # conv OIHW -> HWIO
        return "kernel", np.transpose(w, (2, 3, 1, 0))
    if w.ndim == 2:  # linear [out, in] -> [in, out]
        return "kernel", _t(w)
    return "scale", w  # norm weight


def _sd_convert(sd: Dict[str, np.ndarray], key_filter=None) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, w in sd.items():
        if key_filter is not None:
            key = key_filter(key)
            if key is None:
                continue
        dotted, _, leaf_name = key.rpartition(".")
        path = _sd_flax_path(dotted)
        leaf, arr = _sd_leaf(leaf_name, np.asarray(w))
        node = out
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = arr
    return out


def _leaf_shapes(tree: Dict, prefix: str = "") -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape) if hasattr(v, "shape") else tuple(np.shape(v))
    return out


def _assert_tree_matches(converted: Dict, template: Dict, what: str) -> None:
    """Strict structural + shape check (the converter's built-in test);
    ``template``'s leaves are arrays or shapes."""
    conv_leaves = _leaf_shapes(converted)
    tmpl_leaves = _leaf_shapes(template)
    missing = sorted(set(tmpl_leaves) - set(conv_leaves))
    extra = sorted(set(conv_leaves) - set(tmpl_leaves))
    if missing or extra:
        raise ValueError(
            f"{what}: converted tree mismatch; missing={missing[:5]} "
            f"extra={extra[:5]} (of {len(missing)}/{len(extra)})"
        )
    bad = [(k, conv_leaves[k], tmpl_leaves[k]) for k in tmpl_leaves if conv_leaves[k] != tmpl_leaves[k]]
    if bad:
        raise ValueError(f"{what}: shape mismatches: {bad[:5]}")


def _flax_template(module) -> Dict:
    """A port SD module's parameter tree in the flax layout, as shape-only
    arrays (convolution kernels HWIO, Dense kernels ``[in, out]``): what
    the converted trees must match."""
    from tvc_torch.models.clip import _unflatten
    from tvc_torch.models.sd import Conv, Dense

    owners = dict(module.named_modules())
    flat = {}
    for name, p in module.named_parameters():
        path, _, leaf = name.rpartition(".")
        shape = tuple(p.shape)
        if leaf == "kernel" and isinstance(owners[path], Conv):
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif leaf == "kernel" and isinstance(owners[path], Dense):
            shape = shape[::-1]
        flat[name] = _Shape(shape)
    return _unflatten(flat)


class _Shape(tuple):
    """A leaf that is only a shape (``np.shape`` reads it as one)."""

    @property
    def shape(self) -> tuple:
        return tuple(self)


class _ShapeBook(dict):
    """name -> shape, with the diffusers building blocks' key sets."""

    def conv(self, p: str, out_ch: int, in_ch: int, k: int = 3) -> None:
        self[f"{p}.weight"], self[f"{p}.bias"] = (out_ch, in_ch, k, k), (out_ch,)

    def linear(self, p: str, out_f: int, in_f: int, bias: bool = True) -> None:
        self[f"{p}.weight"] = (out_f, in_f)
        if bias:
            self[f"{p}.bias"] = (out_f,)

    def norm(self, p: str, ch: int) -> None:
        self[f"{p}.weight"] = self[f"{p}.bias"] = (ch,)

    def resnet(self, p: str, in_ch: int, out_ch: int, temb_dim: Optional[int] = None) -> None:
        self.norm(f"{p}.norm1", in_ch)
        self.conv(f"{p}.conv1", out_ch, in_ch)
        if temb_dim:
            self.linear(f"{p}.time_emb_proj", out_ch, temb_dim)
        self.norm(f"{p}.norm2", out_ch)
        self.conv(f"{p}.conv2", out_ch, out_ch)
        if in_ch != out_ch:
            self.conv(f"{p}.conv_shortcut", out_ch, in_ch, k=1)

    def transformer(self, p: str, ch: int, ctx: int) -> None:
        self.norm(f"{p}.norm", ch)
        self.conv(f"{p}.proj_in", ch, ch, k=1)
        tb = f"{p}.transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            self.norm(f"{tb}.{n}", ch)
        for attn, kv in (("attn1", ch), ("attn2", ctx)):
            self.linear(f"{tb}.{attn}.to_q", ch, ch, bias=False)
            self.linear(f"{tb}.{attn}.to_k", ch, kv, bias=False)
            self.linear(f"{tb}.{attn}.to_v", ch, kv, bias=False)
            self.linear(f"{tb}.{attn}.to_out.0", ch, ch)
        self.linear(f"{tb}.ff.net.0.proj", ch * 8, ch)
        self.linear(f"{tb}.ff.net.2", ch, ch * 4)
        self.conv(f"{p}.proj_out", ch, ch, k=1)

    def vae_attention(self, p: str, ch: int) -> None:
        self.norm(f"{p}.group_norm", ch)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            self.linear(f"{p}.{n}", ch, ch)


def sd_unet_state_dict_shapes(config=None) -> Dict[str, tuple]:
    """The names and shapes of a diffusers ``UNet2DConditionModel`` state
    dict at ``config`` (default: SD-1.5's ``unet/``)."""
    from tvc_torch.models.sd_hf import HFUNetConfig

    c = config or HFUNetConfig()
    s = _ShapeBook()
    chs, n = c.block_out_channels, len(c.block_out_channels)
    temb = chs[0] * 4
    s.linear("time_embedding.linear_1", temb, chs[0])
    s.linear("time_embedding.linear_2", temb, temb)
    s.conv("conv_in", chs[0], c.in_channels)
    x, skips = chs[0], [chs[0]]
    for bi, ch in enumerate(chs):
        for li in range(c.layers_per_block):
            s.resnet(f"down_blocks.{bi}.resnets.{li}", x, ch, temb)
            x = ch
            if c.cross_attn_blocks[bi]:
                s.transformer(f"down_blocks.{bi}.attentions.{li}", ch, c.cross_attention_dim)
            skips.append(x)
        if bi < n - 1:
            s.conv(f"down_blocks.{bi}.downsamplers.0.conv", ch, ch)
            skips.append(ch)
    s.resnet("mid_block.resnets.0", x, x, temb)
    s.transformer("mid_block.attentions.0", x, c.cross_attention_dim)
    s.resnet("mid_block.resnets.1", x, x, temb)
    for ui, bi in enumerate(reversed(range(n))):
        ch = chs[bi]
        for li in range(c.layers_per_block + 1):
            s.resnet(f"up_blocks.{ui}.resnets.{li}", x + skips.pop(), ch, temb)
            x = ch
            if c.cross_attn_blocks[bi]:
                s.transformer(f"up_blocks.{ui}.attentions.{li}", ch, c.cross_attention_dim)
        if bi > 0:
            s.conv(f"up_blocks.{ui}.upsamplers.0.conv", ch, ch)
    s.norm("conv_norm_out", x)
    s.conv("conv_out", c.out_channels, x)
    return dict(s)


def sd_vae_state_dict_shapes(config=None) -> Dict[str, tuple]:
    """The names and shapes of a diffusers ``AutoencoderKL`` state dict at
    ``config`` (default: SD-1.5's ``vae/``)."""
    from tvc_torch.models.sd_hf import HFVAEConfig

    c = config or HFVAEConfig()
    s = _ShapeBook()
    chs, n, lat = c.block_out_channels, len(c.block_out_channels), c.latent_channels
    s.conv("encoder.conv_in", chs[0], c.in_channels)
    x = chs[0]
    for bi, ch in enumerate(chs):
        for li in range(c.layers_per_block):
            s.resnet(f"encoder.down_blocks.{bi}.resnets.{li}", x, ch)
            x = ch
        if bi < n - 1:
            s.conv(f"encoder.down_blocks.{bi}.downsamplers.0.conv", ch, ch)
    s.resnet("encoder.mid_block.resnets.0", x, x)
    s.vae_attention("encoder.mid_block.attentions.0", x)
    s.resnet("encoder.mid_block.resnets.1", x, x)
    s.norm("encoder.conv_norm_out", x)
    s.conv("encoder.conv_out", 2 * lat, x)
    s.conv("quant_conv", 2 * lat, 2 * lat, k=1)
    s.conv("post_quant_conv", lat, lat, k=1)
    x = chs[-1]
    s.conv("decoder.conv_in", x, lat)
    s.resnet("decoder.mid_block.resnets.0", x, x)
    s.vae_attention("decoder.mid_block.attentions.0", x)
    s.resnet("decoder.mid_block.resnets.1", x, x)
    for bi, ch in enumerate(reversed(chs)):
        for li in range(c.layers_per_block + 1):
            s.resnet(f"decoder.up_blocks.{bi}.resnets.{li}", x, ch)
            x = ch
        if bi < n - 1:
            s.conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", ch, ch)
    s.norm("decoder.conv_norm_out", x)
    s.conv("decoder.conv_out", c.out_channels, x)
    return dict(s)


def convert_sd_unet_state_dict(sd: Dict[str, np.ndarray], config=None, validate: bool = True) -> Dict[str, Any]:
    """diffusers ``UNet2DConditionModel`` state dict -> ``HFUNet`` params."""
    from tvc_torch.models.sd_hf import HFUNet, HFUNetConfig

    config = config or HFUNetConfig()
    params = _sd_convert(sd)
    if validate:
        _assert_tree_matches(params, _flax_template(HFUNet(config, device="meta")), "sd_unet")
    return params


def convert_sd_vae_state_dict(sd: Dict[str, np.ndarray], config=None, validate: bool = True) -> Dict[str, Any]:
    """diffusers ``AutoencoderKL`` state dict -> ``(HFVAEEncoder params,
    HFVAEDecoder params)``. The AutoencoderKL top-level ``quant_conv`` /
    ``post_quant_conv`` route into encoder / decoder respectively."""
    from tvc_torch.models.sd_hf import HFVAEConfig, HFVAEDecoder, HFVAEEncoder

    config = config or HFVAEConfig()

    def enc_filter(key: str):
        if key.startswith("encoder."):
            return key[len("encoder."):]
        if key.startswith("quant_conv."):
            return key
        return None

    def dec_filter(key: str):
        if key.startswith("decoder."):
            return key[len("decoder."):]
        if key.startswith("post_quant_conv."):
            return key
        return None

    enc_params = _sd_convert(sd, enc_filter)
    dec_params = _sd_convert(sd, dec_filter)
    if validate:
        _assert_tree_matches(enc_params, _flax_template(HFVAEEncoder(config, device="meta")), "sd_vae_encoder")
        _assert_tree_matches(dec_params, _flax_template(HFVAEDecoder(config, device="meta")), "sd_vae_decoder")
    return enc_params, dec_params


def load_sd_weights(
    path: Optional[str] = None,
    image_size: int = 512,
    unet_config=None,
    vae_config=None,
    device=None,
    **sd_kwargs,
):
    """Build a ``StableDiffusionModel`` from a diffusers-layout checkout
    (``$TVC_SD_WEIGHTS`` or ``path``; expects ``unet/`` and ``vae/``
    subdirectories a la runwayml/stable-diffusion-v1-5), on the card
    unless ``device="cpu"``. Returns None when no checkpoint is
    available."""
    from tvc_torch._device import resolve_device
    from tvc_torch.models.sd import SDConfig, StableDiffusionModel, module_tree_from_jax
    from tvc_torch.models.sd_hf import HFUNet, HFUNetConfig, HFVAEConfig, HFVAEDecoder, HFVAEEncoder

    path = path or os.environ.get("TVC_SD_WEIGHTS")
    if not path or not Path(path).exists():
        return None
    device = resolve_device(device)
    root = Path(path)
    unet_config = unet_config or HFUNetConfig()
    vae_config = vae_config or HFVAEConfig()
    unet_params = convert_sd_unet_state_dict(load_state_dict(str(root / "unet")), unet_config)
    enc_params, dec_params = convert_sd_vae_state_dict(load_state_dict(str(root / "vae")), vae_config)
    cfg = SDConfig(
        image_size=image_size,
        context_dim=unet_config.cross_attention_dim,
        vae_scale=vae_config.scaling_factor,
        model_name=str(root),
    )
    modules = {"unet": HFUNet(unet_config, device=device), "vae_enc": HFVAEEncoder(vae_config, device=device),
               "vae_dec": HFVAEDecoder(vae_config, device=device)}
    trees = {"unet": unet_params, "vae_enc": enc_params, "vae_dec": dec_params}
    params = {k: module_tree_from_jax(modules[k], trees[k]) for k in modules}
    del trees, unet_params, enc_params, dec_params
    return StableDiffusionModel(cfg, params=params, device=device, **modules, **sd_kwargs)


# ---------------------------------------------------------------------------
# generic param persistence (SD + fine-tuned models)
# ---------------------------------------------------------------------------


def save_params(params: Any, path: str) -> None:
    """flax msgpack serialization (the bytes ``flax.serialization.to_bytes``
    writes for the same tree)."""
    from tvc_torch._flax_msgpack import write_state_dict

    write_state_dict(path, params)


def load_params(template: Any, path: str) -> Any:
    """The tree saved at ``path`` in ``template``'s structure (flax's
    ``from_bytes``): tensors of ``template`` come back as tensors on its
    device."""
    from tvc_torch._flax_msgpack import from_state_dict, read_state_dict

    return from_state_dict(template, read_state_dict(path))
