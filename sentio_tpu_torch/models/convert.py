"""Hugging Face checkpoint → parameter tree, with numpy and the standard
library — ``sentio_tpu/models/convert.py`` without ``transformers``,
``safetensors`` or ``ml_dtypes``.

The four families map onto the JAX package's trees (dense ``kernel``
``[in, out]``, experts stacked ``[E, in, out]``), so a checkpoint written
here through :func:`sentio_tpu_torch.runtime.weights.save_pytree` loads in
the JAX package's ``load_model`` and in this package's:

* Llama-family ``*ForCausalLM`` → :func:`convert_llama` (a tied
  ``lm_head`` falls back to the embedding);
* Mixtral → :func:`convert_moe`;
* BERT / XLM-R encoders → :func:`convert_encoder` (XLM-R's position offset
  folded in, :func:`_position_offset`);
* ``*ForSequenceClassification`` cross-encoders, both head styles →
  :func:`convert_cross_encoder`.

``config.json`` is read as JSON; a key it leaves out takes the default of
the ``transformers`` class its ``model_type`` names (:data:`HF_DEFAULTS`),
as the JAX package's ``AutoConfig`` gives it. ``*.safetensors`` files are
read through a memory map (``F32``, ``F16``, ``BF16`` and the integer
types; several shards merge), ``pytorch_model*.bin`` through
``torch.load(weights_only=True)``. bf16 stays bf16 on the host as
:data:`~sentio_tpu_torch.runtime.weights.BF16` (its bits as a ``uint16``),
so an 8B checkpoint loads at 16 GB, not 32.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.moe import MoeConfig
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.runtime.weights import BF16


class ConversionError(Exception):
    pass


# ------------------------------------------------------------ bf16 on numpy


def f32_to_bf16(arr: np.ndarray) -> np.ndarray:
    """Round to nearest even, NaN kept quiet (``ml_dtypes``' rule)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    bits = a.view(np.uint32)
    out = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out[nan] = ((bits[nan] >> 16) | np.uint32(0x40)).astype(np.uint16)
    return out.view(BF16)


def bf16_to_f32(arr: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _is_float(arr: np.ndarray) -> bool:
    return arr.dtype == BF16 or np.issubdtype(arr.dtype, np.floating)


def _as_f32(arr: np.ndarray) -> np.ndarray:
    return bf16_to_f32(arr) if arr.dtype == BF16 else arr.astype(np.float32, copy=False)


def cast_leaf(arr: np.ndarray, dtype: str) -> np.ndarray:
    if not _is_float(arr):
        return arr
    if dtype == "bfloat16":
        return arr if arr.dtype == BF16 else f32_to_bf16(arr)
    want = np.dtype(dtype)
    if arr.dtype == want:
        return arr
    return _as_f32(arr).astype(want)


def cast_tree(params: dict, dtype: str) -> dict:
    """Cast every floating leaf to ``dtype`` (integer leaves as they are)."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else cast_leaf(np.asarray(v), dtype)
            for k, v in params.items()}


def _np(t: Any) -> np.ndarray:
    """numpy leaves keep their dtype; torch tensors go through float32, as
    the JAX converter takes them."""
    if isinstance(t, np.ndarray):
        return t
    try:
        return t.detach().to("cpu").float().numpy()
    except AttributeError as e:
        raise ConversionError(f"cannot convert tensor of type {type(t)!r}") from e


def _t(arr: np.ndarray, rows: int = 256) -> np.ndarray:
    """``arr.T`` as a contiguous copy, made a block of rows at a time: a
    plain ``.T.copy()`` of a weight matrix runs several times slower (the
    writes stride across the whole output)."""
    if arr.ndim != 2:
        return arr.T.copy()
    out = np.empty(arr.shape[::-1], arr.dtype)
    for i in range(0, arr.shape[0], rows):
        out[:, i: i + rows] = arr[i: i + rows].T
    return out


def _linear(sd: Mapping[str, Any], prefix: str, with_bias: bool = True) -> dict:
    out = {"kernel": _t(_np(sd[f"{prefix}.weight"]))}
    if with_bias and f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


# ------------------------------------------------------------- config.json

# what ``transformers`` gives a key that config.json leaves out, for every
# model_type this module reads (a None ``num_key_value_heads`` is the head
# count, as LlamaConfig sets it)
HF_DEFAULTS: dict[str, dict[str, Any]] = {
    "llama": dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=None, intermediate_size=11008,
                  max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-6),
    "mistral": dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
                    max_position_embeddings=131072, rope_theta=10000.0, rms_norm_eps=1e-6),
    "mixtral": dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
                    max_position_embeddings=131072, rope_theta=1e6, rms_norm_eps=1e-5,
                    num_local_experts=8, num_experts_per_tok=2),
    "bert": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, pad_token_id=0),
    "roberta": dict(vocab_size=50265, hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072,
                    max_position_embeddings=512, type_vocab_size=2, pad_token_id=1),
    "xlm-roberta": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                        num_attention_heads=12, intermediate_size=3072,
                        max_position_embeddings=512, type_vocab_size=2, pad_token_id=1),
    "camembert": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072,
                      max_position_embeddings=512, type_vocab_size=2, pad_token_id=1),
}


class HFConfig:
    """``config.json`` with the ``transformers`` defaults of its
    ``model_type`` under it: attribute reads as on an ``AutoConfig``."""

    def __init__(self, data: dict, path: str = "config.json") -> None:
        model_type = data.get("model_type", "")
        if model_type not in HF_DEFAULTS:
            raise ConversionError(f"{path}: model_type {model_type!r} is not one the port "
                                  f"converts ({sorted(HF_DEFAULTS)})")
        merged = {**HF_DEFAULTS[model_type], **data}
        if "num_key_value_heads" in merged and merged["num_key_value_heads"] is None:
            merged["num_key_value_heads"] = merged["num_attention_heads"]
        self.__dict__.update(merged)

    @classmethod
    def from_dir(cls, model_dir) -> "HFConfig":
        path = Path(model_dir) / "config.json"
        if not path.is_file():
            raise ConversionError(f"no config.json under {model_dir}")
        return cls(json.loads(path.read_text()), str(path))


# ---------------------------------------------------------------- Llama LM


def _decoder_kwargs_from_hf(hf_cfg: Any, dtype: str) -> dict:
    return dict(
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        mlp_dim=hf_cfg.intermediate_size,
        max_len=getattr(hf_cfg, "max_position_embeddings", 8192),
        rope_theta=getattr(hf_cfg, "rope_theta", 10_000.0),
        dtype=dtype,
        norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-5),
    )


def llama_config_from_hf(hf_cfg: Any, dtype: str = "bfloat16") -> LlamaConfig:
    return LlamaConfig(**_decoder_kwargs_from_hf(hf_cfg, dtype))


def _attn_block(sd: Mapping[str, Any], p: str) -> dict:
    return {
        "wq": _linear(sd, f"{p}.self_attn.q_proj", with_bias=False),
        "wk": _linear(sd, f"{p}.self_attn.k_proj", with_bias=False),
        "wv": _linear(sd, f"{p}.self_attn.v_proj", with_bias=False),
        "wo": _linear(sd, f"{p}.self_attn.o_proj", with_bias=False),
    }


def _decoder_head(sd: Mapping[str, Any]) -> dict:
    embed = _np(sd["model.embed_tokens.weight"])
    # a tied lm_head (Llama-3.2-class checkpoints omit it) is the embedding
    lm_head = _t(_np(sd["lm_head.weight"])) if "lm_head.weight" in sd else _t(embed)
    return {"embed_tokens": {"embedding": embed}, "lm_head": {"kernel": lm_head},
            "final_norm": {"scale": _np(sd["model.norm.weight"])}}


def _check(path: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ConversionError(f"{path}: shape {tuple(got)}, expected {tuple(want)}")


def convert_llama(state_dict: Mapping[str, Any], cfg: LlamaConfig) -> dict:
    """``LlamaForCausalLM.state_dict()`` → params for the llama forward."""
    sd = state_dict
    params = _decoder_head(sd)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        params[f"layers_{i}"] = {
            "attn_norm": {"scale": _np(sd[f"{p}.input_layernorm.weight"])},
            "attn": _attn_block(sd, p),
            "mlp_norm": {"scale": _np(sd[f"{p}.post_attention_layernorm.weight"])},
            "mlp": {
                "w_gate": _linear(sd, f"{p}.mlp.gate_proj", with_bias=False),
                "w_up": _linear(sd, f"{p}.mlp.up_proj", with_bias=False),
                "w_down": _linear(sd, f"{p}.mlp.down_proj", with_bias=False),
            },
        }
    _check("embed_tokens.embedding", params["embed_tokens"]["embedding"].shape,
           (cfg.vocab_size, cfg.dim))
    _check("lm_head.kernel", params["lm_head"]["kernel"].shape, (cfg.dim, cfg.vocab_size))
    _check("layers_0.attn.wk", params["layers_0"]["attn"]["wk"]["kernel"].shape,
           (cfg.dim, cfg.n_kv_heads * cfg.head_dim))
    return params


# ------------------------------------------------------------ Mixtral (MoE)


def moe_config_from_hf(hf_cfg: Any, dtype: str = "bfloat16",
                       capacity_factor: float | None = None) -> MoeConfig:
    """Mixtral routes top-k with no capacity limit, so the default is the
    no-drop ``n_experts / experts_per_token``."""
    n_experts = getattr(hf_cfg, "num_local_experts", 8)
    experts_per_token = getattr(hf_cfg, "num_experts_per_tok", 2)
    if capacity_factor is None:
        capacity_factor = n_experts / experts_per_token
    return MoeConfig(**_decoder_kwargs_from_hf(hf_cfg, dtype), n_experts=n_experts,
                     experts_per_token=experts_per_token, capacity_factor=capacity_factor)


def convert_moe(state_dict: Mapping[str, Any], cfg: MoeConfig) -> dict:
    """``MixtralForCausalLM.state_dict()`` → params for the MoE forward:
    each expert's w1 (gate), w3 (up) and w2 (down) transposed and stacked
    on a leading expert axis, the router as a dense kernel."""
    sd = state_dict
    params = _decoder_head(sd)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        moe_p = f"{p}.block_sparse_moe"

        def stack(w: str) -> np.ndarray:
            return np.stack([_t(_np(sd[f"{moe_p}.experts.{e}.{w}.weight"]))
                             for e in range(cfg.n_experts)])

        params[f"layers_{i}"] = {
            "attn_norm": {"scale": _np(sd[f"{p}.input_layernorm.weight"])},
            "attn": _attn_block(sd, p),
            "mlp_norm": {"scale": _np(sd[f"{p}.post_attention_layernorm.weight"])},
            "moe": {
                "router": {"kernel": _t(_np(sd[f"{moe_p}.gate.weight"]))},
                "w_gate": stack("w1"),
                "w_up": stack("w3"),
                "w_down": stack("w2"),
            },
        }
    _check("embed_tokens.embedding", params["embed_tokens"]["embedding"].shape,
           (cfg.vocab_size, cfg.dim))
    _check("lm_head.kernel", params["lm_head"]["kernel"].shape, (cfg.dim, cfg.vocab_size))
    moe = params["layers_0"]["moe"]
    _check("layers_0.moe.router", moe["router"]["kernel"].shape, (cfg.dim, cfg.n_experts))
    _check("layers_0.moe.w_gate", moe["w_gate"].shape, (cfg.n_experts, cfg.dim, cfg.mlp_dim))
    _check("layers_0.moe.w_down", moe["w_down"].shape, (cfg.n_experts, cfg.mlp_dim, cfg.dim))
    return params


# ------------------------------------------------------- BERT/XLM-R encoder


def _position_offset(hf_cfg: Any) -> int:
    """RoBERTa-family checkpoints index positions from padding_idx+1 = 2;
    BERT from 0 (the JAX expression, its ``None`` branch too)."""
    model_type = getattr(hf_cfg, "model_type", "")
    if model_type in ("roberta", "xlm-roberta", "camembert"):
        return getattr(hf_cfg, "pad_token_id", 1) + 1 if getattr(hf_cfg, "pad_token_id", 1) is not None else 2
    return 0


def encoder_config_from_hf(hf_cfg: Any, dtype: str = "bfloat16") -> EncoderConfig:
    offset = _position_offset(hf_cfg)
    return EncoderConfig(
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        mlp_dim=hf_cfg.intermediate_size,
        max_len=hf_cfg.max_position_embeddings - offset,
        n_types=max(getattr(hf_cfg, "type_vocab_size", 1), 1),
        dtype=dtype,
    )


def _strip_encoder_prefix(sd: Mapping[str, Any]) -> dict:
    for prefix in ("bert.", "roberta.", "model."):
        if any(k.startswith(prefix + "embeddings.") for k in sd):
            plen = len(prefix)
            return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}
    return dict(sd)


def convert_encoder(state_dict: Mapping[str, Any], cfg: EncoderConfig,
                    position_offset: int = 0) -> dict:
    """BERT/XLM-R ``*Model.state_dict()`` (bare or ``bert.`` / ``roberta.``
    / ``model.`` prefixed) → params for the encoder forward."""
    sd = _strip_encoder_prefix(state_dict)
    pos = _np(sd["embeddings.position_embeddings.weight"])
    if position_offset:
        pos = pos[position_offset:]
    if "embeddings.token_type_embeddings.weight" in sd:
        types = _np(sd["embeddings.token_type_embeddings.weight"])
    else:  # RoBERTa variants ship a single (or no) type row
        types = np.zeros((cfg.n_types, cfg.dim), np.float32)
    if types.shape[0] < cfg.n_types:  # missing type rows are zeros
        types = np.concatenate([_as_f32(types), np.zeros((cfg.n_types - types.shape[0],
                                                          cfg.dim), np.float32)])
    params: dict = {
        "embed_tokens": {"embedding": _np(sd["embeddings.word_embeddings.weight"])},
        "embed_positions": {"embedding": pos.copy()},
        "embed_types": {"embedding": types},
        "embed_norm": {
            "scale": _np(sd["embeddings.LayerNorm.weight"]),
            "bias": _np(sd["embeddings.LayerNorm.bias"]),
        },
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}"
        params[f"layers_{i}"] = {
            "attn": {
                "wq": _linear(sd, f"{p}.attention.self.query"),
                "wk": _linear(sd, f"{p}.attention.self.key"),
                "wv": _linear(sd, f"{p}.attention.self.value"),
                "wo": _linear(sd, f"{p}.attention.output.dense"),
            },
            "attn_norm": {
                "scale": _np(sd[f"{p}.attention.output.LayerNorm.weight"]),
                "bias": _np(sd[f"{p}.attention.output.LayerNorm.bias"]),
            },
            "mlp": {
                "w_in": _linear(sd, f"{p}.intermediate.dense"),
                "w_out": _linear(sd, f"{p}.output.dense"),
            },
            "mlp_norm": {
                "scale": _np(sd[f"{p}.output.LayerNorm.weight"]),
                "bias": _np(sd[f"{p}.output.LayerNorm.bias"]),
            },
        }
    return params


def convert_cross_encoder(state_dict: Mapping[str, Any], cfg: EncoderConfig,
                          position_offset: int = 0) -> dict:
    """``*ForSequenceClassification`` (one label) → encoder tree + pooler +
    scalar head: RoBERTa's ``classifier.dense`` / ``classifier.out_proj``,
    or BERT's ``bert.pooler.dense`` / ``classifier``."""
    sd = state_dict
    params: dict = {"encoder": convert_encoder(state_dict, cfg, position_offset)}
    if "classifier.out_proj.weight" in sd:
        params["pooler"] = _linear(sd, "classifier.dense")
        params["head"] = _linear(sd, "classifier.out_proj")
    elif "classifier.weight" in sd:
        for pfx in ("bert.pooler.dense", "pooler.dense"):
            if f"{pfx}.weight" in sd:
                params["pooler"] = _linear(sd, pfx)
                break
        params["head"] = _linear(sd, "classifier")
    else:
        raise ConversionError("no classifier head found in state dict")
    if params["head"]["kernel"].shape[1] != 1:
        raise ConversionError(
            f"cross-encoder head must be scalar, got {params['head']['kernel'].shape[1]} labels")
    return params


# ---------------------------------------------------------------- loaders

_ST_DTYPES = {"F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
              "BF16": BF16, "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
              "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"),
              "BOOL": np.dtype("?")}


def read_safetensors(path) -> dict[str, np.ndarray]:
    """One ``.safetensors`` file → {name: array}: a little-endian u64
    header length, the JSON header, then the raw bytes, read through a
    memory map (leaves are read-only views until copied)."""
    path = Path(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n) \
        if path.stat().st_size > 8 + n else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ConversionError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                  "which the port does not read")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = data[start:end]
        if raw.size != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise ConversionError(f"{path}: tensor {name!r} holds {raw.size} bytes, not "
                                  f"{shape} of {info['dtype']}")
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_state_dict(model_dir) -> dict:
    """A checkpoint directory's tensors, without building a model:
    every ``*.safetensors`` shard (in name order), else every
    ``pytorch_model*.bin``."""
    model_dir = Path(model_dir)
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        sd: dict = {}
        for f in st_files:
            sd.update(read_safetensors(f))
        return sd
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bins:
        raise ConversionError(f"no safetensors or torch .bin files under {model_dir}")
    import torch

    sd = {}
    for f in bins:
        sd.update(torch.load(str(f), map_location="cpu", weights_only=True))
    return sd


def load_llama_dir(model_dir, dtype: str = "bfloat16") -> tuple[dict, LlamaConfig]:
    cfg = llama_config_from_hf(HFConfig.from_dir(model_dir), dtype=dtype)
    return cast_tree(convert_llama(load_state_dict(model_dir), cfg), dtype), cfg


def load_moe_dir(model_dir, dtype: str = "bfloat16") -> tuple[dict, MoeConfig]:
    cfg = moe_config_from_hf(HFConfig.from_dir(model_dir), dtype=dtype)
    return cast_tree(convert_moe(load_state_dict(model_dir), cfg), dtype), cfg


def load_encoder_dir(model_dir, dtype: str = "bfloat16",
                     cross_encoder: bool = False) -> tuple[dict, EncoderConfig]:
    hf_cfg = HFConfig.from_dir(model_dir)
    cfg = encoder_config_from_hf(hf_cfg, dtype=dtype)
    offset = _position_offset(hf_cfg)
    sd = load_state_dict(model_dir)
    params = convert_cross_encoder(sd, cfg, offset) if cross_encoder \
        else convert_encoder(sd, cfg, offset)
    return cast_tree(params, dtype), cfg


def load_family_dir(family: str, model_dir, dtype: str = "bfloat16"):
    """(params, config) of ``family`` from an HF checkpoint directory."""
    if family == "llama":
        return load_llama_dir(model_dir, dtype)
    if family == "moe":
        return load_moe_dir(model_dir, dtype)
    if family in ("encoder", "cross-encoder"):
        return load_encoder_dir(model_dir, dtype, cross_encoder=family == "cross-encoder")
    raise ValueError(f"unknown family {family!r}: llama, moe, encoder or cross-encoder")
