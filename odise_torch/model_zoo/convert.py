"""Reference checkpoints into the port (counterpart of
``odise_tpu/model_zoo/convert.py``).

The maps are the JAX package's, in numpy: each turns a torch ``state_dict``
of the reference's layout (CompVis Stable Diffusion, OpenAI CLIP, the
released ODISE checkpoints' trainable set) into a tree of flax scope names,
the same tree the JAX converter gives; the port names its modules after
those scopes, so ``from_jax.load_flax_subtree`` fills a port model from it.

Layout rules:
  * Conv2d  [out,in,kh,kw] -> kernel [kh,kw,in,out]
  * Linear  [out,in]       -> kernel [in,out]
  * Group/LayerNorm weight/bias -> scale/bias
  * nn.MultiheadAttention in_proj_weight [3C,C] -> in_proj kernel [C,3C]

The installers (``install_sd_weights``, ``install_ldm_weights``,
``install_clip_weights``, ``install_odise_trainable``) fill a port model in
place, raise on a converted leaf that names no tensor or does not fit its
shape, and raise if a tower they install is left with a tensor unfilled;
``sd_install``, ``ldm_install``, ``clip_install`` and ``odise_install``
give what they install.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch.nn as nn

from .from_jax import load_flax_subtree


def t_conv(w) -> np.ndarray:
    return np.asarray(w).transpose(2, 3, 1, 0)


def t_lin(w) -> np.ndarray:
    return np.asarray(w).transpose(1, 0)


def _set(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = np.asarray(value)


def _norm(sd: Mapping, tree: dict, src: str, dst: str):
    _set(tree, f"{dst}/scale", sd[f"{src}.weight"])
    _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _conv(sd: Mapping, tree: dict, src: str, dst: str, bias=True):
    _set(tree, f"{dst}/kernel", t_conv(sd[f"{src}.weight"]))
    if bias and f"{src}.bias" in sd:
        _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _lin(sd: Mapping, tree: dict, src: str, dst: str, bias=True):
    _set(tree, f"{dst}/kernel", t_lin(sd[f"{src}.weight"]))
    if bias and f"{src}.bias" in sd:
        _set(tree, f"{dst}/bias", sd[f"{src}.bias"])


def _strip(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# SD VAE (CompVis first_stage_model)
# ---------------------------------------------------------------------------


def _vae_resblock(sd, tree, src, dst):
    _norm(sd, tree, f"{src}.norm1", f"{dst}/norm1/norm")
    _conv(sd, tree, f"{src}.conv1", f"{dst}/conv1")
    _norm(sd, tree, f"{src}.norm2", f"{dst}/norm2/norm")
    _conv(sd, tree, f"{src}.conv2", f"{dst}/conv2")
    if f"{src}.nin_shortcut.weight" in sd:
        _conv(sd, tree, f"{src}.nin_shortcut", f"{dst}/nin_shortcut")


def _vae_attn(sd, tree, src, dst):
    _norm(sd, tree, f"{src}.norm", f"{dst}/norm/norm")
    for n in ("q", "k", "v", "proj_out"):
        _conv(sd, tree, f"{src}.{n}", f"{dst}/{n}")


def convert_sd_vae(sd: Mapping, prefix: str = "first_stage_model.",
                   num_levels: int = 4, num_res_blocks: int = 2) -> dict:
    """CompVis AutoencoderKL state dict -> AutoencoderKL scope tree."""
    sd = _strip(sd, prefix)
    tree: dict = {}
    _conv(sd, tree, "encoder.conv_in", "encoder/conv_in")
    for i in range(num_levels):
        for j in range(num_res_blocks):
            _vae_resblock(sd, tree, f"encoder.down.{i}.block.{j}",
                          f"encoder/down_{i}_block_{j}")
        if i != num_levels - 1:
            _conv(sd, tree, f"encoder.down.{i}.downsample.conv",
                  f"encoder/down_{i}_downsample/conv")
    _vae_resblock(sd, tree, "encoder.mid.block_1", "encoder/mid_block_1")
    _vae_attn(sd, tree, "encoder.mid.attn_1", "encoder/mid_attn_1")
    _vae_resblock(sd, tree, "encoder.mid.block_2", "encoder/mid_block_2")
    _norm(sd, tree, "encoder.norm_out", "encoder/norm_out/norm")
    _conv(sd, tree, "encoder.conv_out", "encoder/conv_out")
    _conv(sd, tree, "decoder.conv_in", "decoder/conv_in")
    _vae_resblock(sd, tree, "decoder.mid.block_1", "decoder/mid_block_1")
    _vae_attn(sd, tree, "decoder.mid.attn_1", "decoder/mid_attn_1")
    _vae_resblock(sd, tree, "decoder.mid.block_2", "decoder/mid_block_2")
    for i in range(num_levels):
        for j in range(num_res_blocks + 1):
            _vae_resblock(sd, tree, f"decoder.up.{i}.block.{j}",
                          f"decoder/up_{i}_block_{j}")
        if i != 0:
            _conv(sd, tree, f"decoder.up.{i}.upsample.conv",
                  f"decoder/up_{i}_upsample/conv")
    _norm(sd, tree, "decoder.norm_out", "decoder/norm_out/norm")
    _conv(sd, tree, "decoder.conv_out", "decoder/conv_out")
    # quant convs (outside encoder/decoder in CompVis)
    _conv(sd, tree, "quant_conv", "quant_conv")
    _conv(sd, tree, "post_quant_conv", "post_quant_conv")
    return tree


# ---------------------------------------------------------------------------
# SD UNet (CompVis model.diffusion_model)
# ---------------------------------------------------------------------------


def _unet_resblock(sd, tree, src, dst):
    _norm(sd, tree, f"{src}.in_layers.0", f"{dst}/in_norm/norm")
    _conv(sd, tree, f"{src}.in_layers.2", f"{dst}/in_conv")
    _lin(sd, tree, f"{src}.emb_layers.1", f"{dst}/emb_proj")
    _norm(sd, tree, f"{src}.out_layers.0", f"{dst}/out_norm/norm")
    _conv(sd, tree, f"{src}.out_layers.3", f"{dst}/out_conv")
    if f"{src}.skip_connection.weight" in sd:
        _conv(sd, tree, f"{src}.skip_connection", f"{dst}/skip")


def _unet_spatial_transformer(sd, tree, src, dst, depth=1):
    _norm(sd, tree, f"{src}.norm", f"{dst}/norm/norm")
    _conv(sd, tree, f"{src}.proj_in", f"{dst}/proj_in")
    for d in range(depth):
        b = f"{src}.transformer_blocks.{d}"
        o = f"{dst}/block_{d}"
        for attn in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _lin(sd, tree, f"{b}.{attn}.{n}", f"{o}/{attn}/{n}", bias=False)
            _lin(sd, tree, f"{b}.{attn}.to_out.0", f"{o}/{attn}/to_out")
        _lin(sd, tree, f"{b}.ff.net.0.proj", f"{o}/ff_geglu/proj")
        _lin(sd, tree, f"{b}.ff.net.2", f"{o}/ff_out")
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, tree, f"{b}.{n}", f"{o}/{n}")
    _conv(sd, tree, f"{src}.proj_out", f"{dst}/proj_out")


def convert_sd_unet(sd: Mapping, prefix: str = "model.diffusion_model.",
                    channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                    attention_ds=(1, 2, 4)) -> dict:
    """CompVis UNetModel state dict -> UNetModel scope tree."""
    sd = _strip(sd, prefix)
    tree: dict = {}
    _lin(sd, tree, "time_embed.0", "time_embed_0")
    _lin(sd, tree, "time_embed.2", "time_embed_2")
    _conv(sd, tree, "input_blocks.0.0", "input_conv")

    ds = 1
    k = 0
    for i_level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            k += 1
            _unet_resblock(sd, tree, f"input_blocks.{k}.0", f"in_{k}_res")
            if ds in attention_ds:
                _unet_spatial_transformer(sd, tree, f"input_blocks.{k}.1",
                                          f"in_{k}_attn")
        if i_level != len(channel_mult) - 1:
            k += 1
            _conv(sd, tree, f"input_blocks.{k}.0.op", f"in_{k}_down/op")
            ds *= 2

    _unet_resblock(sd, tree, "middle_block.0", "mid_res_0")
    _unet_spatial_transformer(sd, tree, "middle_block.1", "mid_attn")
    _unet_resblock(sd, tree, "middle_block.2", "mid_res_1")

    out_idx = 0
    for i_level in reversed(range(len(channel_mult))):
        for i_block in range(num_res_blocks + 1):
            _unet_resblock(sd, tree, f"output_blocks.{out_idx}.0",
                           f"out_{out_idx}_res")
            mod = 1
            if ds in attention_ds:
                _unet_spatial_transformer(
                    sd, tree, f"output_blocks.{out_idx}.{mod}",
                    f"out_{out_idx}_attn")
                mod += 1
            if i_level != 0 and i_block == num_res_blocks:
                _conv(sd, tree, f"output_blocks.{out_idx}.{mod}.conv",
                      f"out_{out_idx}_up/conv")
                ds //= 2
            out_idx += 1

    _norm(sd, tree, "out.0", "out_norm/norm")
    _conv(sd, tree, "out.2", "out_conv")
    return tree


# ---------------------------------------------------------------------------
# CLIP towers (OpenAI / open_clip layout; SD's text tower also as Hugging Face)
# ---------------------------------------------------------------------------


def _clip_resblock(sd, tree, src, dst):
    w = np.asarray(sd[f"{src}.attn.in_proj_weight"])
    b = np.asarray(sd[f"{src}.attn.in_proj_bias"])
    _set(tree, f"{dst}/attn/in_proj/kernel", w.transpose(1, 0))
    _set(tree, f"{dst}/attn/in_proj/bias", b)
    _lin(sd, tree, f"{src}.attn.out_proj", f"{dst}/attn/out_proj")
    _norm(sd, tree, f"{src}.ln_1", f"{dst}/ln_1")
    _norm(sd, tree, f"{src}.ln_2", f"{dst}/ln_2")
    _lin(sd, tree, f"{src}.mlp.c_fc", f"{dst}/c_fc")
    _lin(sd, tree, f"{src}.mlp.c_proj", f"{dst}/c_proj")


def convert_clip_vision(sd: Mapping, prefix: str = "visual.",
                        layers: int = 24) -> dict:
    """OpenAI CLIP visual tower state dict -> VisionTransformer scope tree."""
    sd = _strip(sd, prefix)
    tree: dict = {}
    _set(tree, "conv1/kernel", t_conv(sd["conv1.weight"]))
    _set(tree, "class_embedding", sd["class_embedding"])
    _set(tree, "positional_embedding", sd["positional_embedding"])
    _norm(sd, tree, "ln_pre", "ln_pre")
    _norm(sd, tree, "ln_post", "ln_post")
    _set(tree, "proj", sd["proj"])  # [width, embed] already
    for i in range(layers):
        _clip_resblock(sd, tree, f"transformer.resblocks.{i}",
                       f"transformer/resblock_{i}")
    return tree


def convert_clip_text(sd: Mapping, layers: int = 12) -> dict:
    """OpenAI CLIP text tower state dict -> TextTransformer scope tree.
    A state without ``text_projection`` (the Hugging Face layout, repacked
    by ``hf_clip_text_to_openai``) gives a tree without it."""
    tree: dict = {}
    _set(tree, "token_embedding/embedding", sd["token_embedding.weight"])
    _set(tree, "positional_embedding", sd["positional_embedding"])
    _norm(sd, tree, "ln_final", "ln_final")
    if "text_projection" in sd:
        _set(tree, "text_projection", sd["text_projection"])
    for i in range(layers):
        _clip_resblock(sd, tree, f"transformer.resblocks.{i}",
                       f"transformer/resblock_{i}")
    return tree


HF_TEXT_TOKEN = "text_model.embeddings.token_embedding.weight"


def hf_clip_text_to_openai(sd: Mapping, layers: int = 12) -> dict:
    """Hugging Face ``CLIPTextModel`` state (``text_model.*``, as CompVis SD
    v1 checkpoints hold their text encoder) -> the OpenAI layout that
    ``convert_clip_text`` reads: q, k and v packed into ``in_proj``. The
    layout has no ``text_projection`` and none is made: the SD tower uses
    the final hidden states and never applies it."""
    e, enc = "text_model.embeddings", "text_model.encoder.layers"
    out = {"token_embedding.weight": sd[f"{e}.token_embedding.weight"],
           "positional_embedding": sd[f"{e}.position_embedding.weight"],
           "ln_final.weight": sd["text_model.final_layer_norm.weight"],
           "ln_final.bias": sd["text_model.final_layer_norm.bias"]}
    rename = {"self_attn.out_proj": "attn.out_proj", "layer_norm1": "ln_1",
              "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}
    for i in range(layers):
        src, dst = f"{enc}.{i}", f"transformer.resblocks.{i}"
        for kind in ("weight", "bias"):
            out[f"{dst}.attn.in_proj_{kind}"] = np.concatenate(
                [np.asarray(sd[f"{src}.self_attn.{n}_proj.{kind}"]) for n in "qkv"])
            for a, b in rename.items():
                out[f"{dst}.{b}.{kind}"] = sd[f"{src}.{a}.{kind}"]
    return out


# ---------------------------------------------------------------------------
# Released ODISE checkpoints (the ~28M trainable params)
# ---------------------------------------------------------------------------


def _mha_packed(sd: Mapping, tree: dict, src: str, dst: str) -> None:
    """torch nn.MultiheadAttention (packed qkv) -> separate q/k/v/out Dense."""
    w = np.asarray(sd[f"{src}.in_proj_weight"])
    b = np.asarray(sd[f"{src}.in_proj_bias"])
    C = w.shape[1]
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        _set(tree, f"{dst}/{name}/kernel", w[i * C:(i + 1) * C].transpose(1, 0))
        _set(tree, f"{dst}/{name}/bias", b[i * C:(i + 1) * C])
    _lin(sd, tree, f"{src}.out_proj", f"{dst}/out_proj")


def _d2_conv_gn(sd: Mapping, tree: dict, src: str, dst_conv: str,
                dst_norm: str) -> None:
    """d2 Conv2d with attached .norm (GroupNorm); absent convs are skipped
    (e.g. BottleneckBlock has no shortcut when channels match)."""
    if f"{src}.weight" not in sd:
        return
    _conv(sd, tree, src, dst_conv)
    if f"{src}.norm.weight" in sd:
        _set(tree, f"{dst_norm}/scale", sd[f"{src}.norm.weight"])
        _set(tree, f"{dst_norm}/bias", sd[f"{src}.norm.bias"])


def convert_odise_trainable(sd: Mapping, num_projections: int = 8,
                            enc_layers: int = 6, dec_layers: int = 9,
                            fpn_steps: int = 1, mlp_layers: int = 3) -> dict:
    """Reference ODISE checkpoint (trainable subset) -> scope tree.

    Maps the reference module names (FeatureExtractorBackbone projections,
    MSDeformAttnPixelDecoder, ODISEMultiScaleMaskedTransformerDecoder with
    PooledMaskEmbed, CategoryEmbed/WordEmbed, implicit-captioner projections)
    onto the scopes. Frozen SD/CLIP weights are absent from these
    checkpoints by design.
    """
    tree: dict = {}

    # backbone feature projections (d2 BottleneckBlock, GN)
    for i in range(num_projections):
        src = f"backbone.feature_projections.{i}.0"
        if f"{src}.conv1.weight" not in sd:
            continue
        dst = f"backbone/proj_{i}"
        _d2_conv_gn(sd, tree, f"{src}.shortcut", f"{dst}/shortcut", f"{dst}/shortcut_norm")
        _d2_conv_gn(sd, tree, f"{src}.conv1", f"{dst}/conv1", f"{dst}/norm1")
        _d2_conv_gn(sd, tree, f"{src}.conv2", f"{dst}/conv2", f"{dst}/norm2")
        _d2_conv_gn(sd, tree, f"{src}.conv3", f"{dst}/conv3", f"{dst}/norm3")

    # implicit captioner trainable pieces
    fx = "backbone.feature_extractor"
    cap = "backbone/feature_extractor"
    if f"{fx}.clip_project.linear.weight" in sd:
        _lin(sd, tree, f"{fx}.clip_project.linear", f"{cap}/clip_project/linear")
        _set(tree, f"{cap}/clip_project/positional_embedding",
             sd[f"{fx}.clip_project.positional_embedding"])
    if f"{fx}.alpha_cond" in sd:
        # the reference's shape [1, 77, ctx] (zeros_like(uncond_inputs))
        _set(tree, f"{cap}/alpha_cond", sd[f"{fx}.alpha_cond"])
    if f"{fx}.time_embed_project.linear.weight" in sd:
        _lin(sd, tree, f"{fx}.time_embed_project.linear",
             f"{cap}/time_embed_project/linear")
        _set(tree, f"{cap}/time_embed_project/positional_embedding",
             sd[f"{fx}.time_embed_project.positional_embedding"])
        # the reference stores a 1-D [time_embed_dim] vector; the scope
        # holds [1, time_embed_dim]
        _set(tree, f"{cap}/alpha_cond_time_embed",
             np.reshape(sd[f"{fx}.alpha_cond_time_embed"], (1, -1)))

    # pixel decoder
    pd = "sem_seg_head.pixel_decoder"
    dpd = "sem_seg_head/pixel_decoder"
    for i in range(3):
        if f"{pd}.input_proj.{i}.0.weight" in sd:
            _conv(sd, tree, f"{pd}.input_proj.{i}.0", f"{dpd}/input_proj_{i}")
            _set(tree, f"{dpd}/input_proj_norm_{i}/scale",
                 sd[f"{pd}.input_proj.{i}.1.weight"])
            _set(tree, f"{dpd}/input_proj_norm_{i}/bias",
                 sd[f"{pd}.input_proj.{i}.1.bias"])
    if f"{pd}.transformer.level_embed" in sd:
        _set(tree, f"{dpd}/level_embed", sd[f"{pd}.transformer.level_embed"])
    for i in range(enc_layers):
        src = f"{pd}.transformer.encoder.layers.{i}"
        dst = f"{dpd}/encoder_layer_{i}"
        for n in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            _lin(sd, tree, f"{src}.self_attn.{n}", f"{dst}/self_attn/{n}")
        _lin(sd, tree, f"{src}.linear1", f"{dst}/linear1")
        _lin(sd, tree, f"{src}.linear2", f"{dst}/linear2")
        _norm(sd, tree, f"{src}.norm1", f"{dst}/norm1")
        _norm(sd, tree, f"{src}.norm2", f"{dst}/norm2")
    for j in range(fpn_steps):
        _d2_conv_gn(sd, tree, f"{pd}.lateral_convs.{j}", f"{dpd}/lateral_{j}",
                    f"{dpd}/lateral_norm_{j}")
        _d2_conv_gn(sd, tree, f"{pd}.output_convs.{j}", f"{dpd}/output_conv_{j}",
                    f"{dpd}/output_norm_{j}")
    if f"{pd}.mask_features.weight" in sd:
        _conv(sd, tree, f"{pd}.mask_features", f"{dpd}/mask_features")

    # transformer decoder (predictor)
    pr = "sem_seg_head.predictor"
    dpr = "sem_seg_head/transformer_predictor"
    for name in ("query_feat", "query_embed", "level_embed"):
        if f"{pr}.{name}.weight" in sd:
            _set(tree, f"{dpr}/{name}", sd[f"{pr}.{name}.weight"])
    for i in range(dec_layers):
        _mha_packed(sd, tree,
                    f"{pr}.transformer_cross_attention_layers.{i}.multihead_attn",
                    f"{dpr}/cross_{i}/attn")
        _norm(sd, tree, f"{pr}.transformer_cross_attention_layers.{i}.norm",
              f"{dpr}/cross_{i}/norm")
        _mha_packed(sd, tree,
                    f"{pr}.transformer_self_attention_layers.{i}.self_attn",
                    f"{dpr}/self_{i}/attn")
        _norm(sd, tree, f"{pr}.transformer_self_attention_layers.{i}.norm",
              f"{dpr}/self_{i}/norm")
        _lin(sd, tree, f"{pr}.transformer_ffn_layers.{i}.linear1",
             f"{dpr}/ffn_{i}/linear1")
        _lin(sd, tree, f"{pr}.transformer_ffn_layers.{i}.linear2",
             f"{dpr}/ffn_{i}/linear2")
        _norm(sd, tree, f"{pr}.transformer_ffn_layers.{i}.norm",
              f"{dpr}/ffn_{i}/norm")
    _norm(sd, tree, f"{pr}.decoder_norm", f"{dpr}/decoder_norm")
    for i in range(mlp_layers):
        if f"{pr}.mask_embed.layers.{i}.weight" in sd:
            _lin(sd, tree, f"{pr}.mask_embed.layers.{i}",
                 f"{dpr}/mask_embed_mlp/layer_{i}")
    # PooledMaskEmbed
    pme = f"{pr}.post_mask_embed"
    dpme = f"{dpr}/post_mask_embed"
    if f"{pme}.pool_proj.0.weight" in sd:
        _norm(sd, tree, f"{pme}.pool_proj.0", f"{dpme}/pool_norm")
        _lin(sd, tree, f"{pme}.pool_proj.1", f"{dpme}/pool_proj")
        _norm(sd, tree, f"{pme}.mask_embed.0", f"{dpme}/embed_norm")
        for i in range(mlp_layers):
            _lin(sd, tree, f"{pme}.mask_embed.1.layers.{i}",
                 f"{dpme}/embed_mlp/layer_{i}")
        _set(tree, f"{dpme}/logit_scale", sd[f"{pme}.logit_scale"])

    # category / word heads
    if "category_head.text_proj.weight" in sd:
        _lin(sd, tree, "category_head.text_proj", "category_head/text_proj")
        _set(tree, "category_head/null_embed", sd["category_head.null_embed"])
    if "word_head.text_proj.weight" in sd:
        _lin(sd, tree, "word_head.text_proj", "word_head/word_proj")

    return tree


# ---------------------------------------------------------------------------
# Files, and filling a port model
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth/.ckpt/.safetensors file into numpy (on the CPU)."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in obj.items()}


def _layers(transformer: nn.Module) -> int:
    return int(transformer.layers)


class Install(NamedTuple):
    """A converted checkpoint for one model: the scope tree, the dotted
    towers it must fill whole, and the tensors of those it may leave."""

    tree: dict
    towers: Tuple[str, ...]
    may_leave: Tuple[str, ...] = ()


def _sd_tree(sd_state: Mapping, text_layers: int, text_name: str):
    """SD's towers as one scope tree (``vae``, ``unet`` and, where the
    state holds it, the text encoder as ``text_name``), the names of the
    towers it fills and the tensors it may leave, relative to the scope."""
    tree = {"vae": convert_sd_vae(sd_state), "unet": convert_sd_unet(sd_state)}
    towers, may_leave = ["vae", "unet"], []
    text = _strip(sd_state, "cond_stage_model.transformer.")
    if text:
        if HF_TEXT_TOKEN in text:
            text = hf_clip_text_to_openai(text, text_layers)
            may_leave.append(f"{text_name}.text_projection")
        tree[text_name] = convert_clip_text(text, layers=text_layers)
        towers.append(text_name)
    return tree, towers, may_leave


def sd_install(model: nn.Module, sd_state: Mapping) -> Install:
    """SD's VAE, UNet and, where the state holds it, text encoder, under
    ``backbone.feature_extractor.ldm_extractor``.

    The text encoder is read in the OpenAI layout the JAX converter reads
    (``cond_stage_model.transformer.token_embedding.weight``, ...) or in
    the Hugging Face layout CompVis SD v1 checkpoints hold it in
    (``cond_stage_model.transformer.text_model.*``); in the latter the
    tower's ``text_projection`` stays as built, which the SD tower never
    applies.
    """
    scope = "backbone.feature_extractor.ldm_extractor"
    tree, towers, may_leave = _sd_tree(
        sd_state, _layers(model.backbone.feature_extractor.ldm_extractor.sd_text.transformer),
        "sd_text")
    return Install({"backbone": {"feature_extractor": {"ldm_extractor": tree}}},
                   tuple(f"{scope}.{t}" for t in towers),
                   tuple(f"{scope}.{t}" for t in may_leave))


def ldm_install(model: nn.Module, sd_state: Mapping) -> Install:
    """SD's three towers into ``models.sd.LatentDiffusion`` (``vae``,
    ``unet``, ``text_encoder``), each of which must be filled whole; the
    text encoder in either layout, as ``sd_install`` reads it."""
    tree, _, may_leave = _sd_tree(sd_state, _layers(model.text_encoder.transformer),
                                  "text_encoder")
    return Install(tree, ("vae", "unet", "text_encoder"), tuple(may_leave))


def clip_install(model: nn.Module, clip_state: Mapping,
                 layers_vision: Optional[int] = None, layers_text: Optional[int] = None,
                 clip_head_state: Optional[Mapping] = None) -> Install:
    """OpenAI CLIP into the captioner's vision tower, the vocabulary text
    tower and, if the model has one, the CLIP head. Layer counts default to
    the model's.

    The JAX installer writes ``clip_state``'s vision tower into the CLIP
    head too; the head of the shipped model is ViT-L/14 at 336 px (577
    positions) and the captioner's ViT-L/14 at 224 px (257), so that state
    does not fit it. Pass the 336-px checkpoint as ``clip_head_state`` (its
    ``visual.*`` and ``logit_scale``).
    """
    if layers_vision is None:
        layers_vision = _layers(model.backbone.feature_extractor.clip_visual.transformer)
    if layers_text is None:
        layers_text = _layers(model.text_encoder.transformer)
    tree = {"backbone": {"feature_extractor": {
                "clip_visual": convert_clip_vision(clip_state, layers=layers_vision)}},
            "text_encoder": convert_clip_text(clip_state, layers=layers_text)}
    towers = ["backbone.feature_extractor.clip_visual", "text_encoder"]
    if getattr(model, "clip_head", None) is not None:
        head = clip_state if clip_head_state is None else clip_head_state
        tree["clip_head"] = {
            "clip_visual": convert_clip_vision(
                head, layers=_layers(model.clip_head.clip_visual.transformer)),
            "logit_scale": np.asarray(head["logit_scale"])}
        towers.append("clip_head")
    return Install(tree, tuple(towers))


def odise_install(model: nn.Module, state: Mapping, num_projections: int = 8,
                  enc_layers: Optional[int] = None, dec_layers: Optional[int] = None,
                  fpn_steps: int = 1, mlp_layers: int = 3) -> Install:
    """A released ODISE checkpoint's trainable set (``convert_odise_trainable``);
    every trainable tensor is its tower. Layer counts default to the
    model's."""
    from ..engine.train_loop import is_frozen_path

    head = model.sem_seg_head
    if enc_layers is None:
        enc_layers = head.pixel_decoder.enc_layers
    if dec_layers is None:
        dec_layers = head.transformer_predictor.dec_layers
    tree = convert_odise_trainable(state, num_projections, enc_layers, dec_layers,
                                   fpn_steps, mlp_layers)
    trainable = tuple(n for n in model.state_dict() if not is_frozen_path(tuple(n.split("."))))
    return Install(tree, trainable)


def install(model: nn.Module, what: Install) -> None:
    """Load ``what.tree`` into ``model`` in place; raise if a tensor of one
    of its towers (a dotted prefix or a tensor's own name) is left
    unfilled, but for ``what.may_leave``. Nothing is written when a leaf
    names no tensor or does not fit one."""
    unfilled = load_flax_subtree(model, what.tree)
    left = [n for n in unfilled if n not in what.may_leave
            and any(n == t or n.startswith(t + ".") for t in what.towers)]
    if left:
        raise KeyError(f"the checkpoint left {len(left)} tensors of its towers unfilled: "
                       f"{left[:8]}")


def install_sd_weights(model: nn.Module, sd_state: Mapping) -> None:
    """Install SD weights into ``model`` in place (``sd_install``)."""
    install(model, sd_install(model, sd_state))


def install_ldm_weights(model: nn.Module, sd_state: Mapping) -> None:
    """Install SD v1's weights into a ``LatentDiffusion`` in place
    (``ldm_install``)."""
    install(model, ldm_install(model, sd_state))


def install_clip_weights(model: nn.Module, clip_state: Mapping,
                         layers_vision: Optional[int] = None,
                         layers_text: Optional[int] = None,
                         clip_head_state: Optional[Mapping] = None) -> None:
    """Install CLIP weights into ``model`` in place (``clip_install``);
    raises where the CLIP head gets a state that does not fit it."""
    install(model, clip_install(model, clip_state, layers_vision, layers_text,
                                clip_head_state))


def install_odise_trainable(model: nn.Module, state: Mapping, num_projections: int = 8,
                            enc_layers: Optional[int] = None,
                            dec_layers: Optional[int] = None,
                            fpn_steps: int = 1, mlp_layers: int = 3) -> None:
    """Install a released ODISE checkpoint's trainable set into ``model``
    in place (``odise_install``): every trainable tensor must be filled."""
    install(model, odise_install(model, state, num_projections, enc_layers, dec_layers,
                                 fpn_steps, mlp_layers))
