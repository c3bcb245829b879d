"""Carry weights into the port.

* ``llama_from_jax`` / ``moe_from_jax`` / ``encoder_from_jax`` /
  ``cross_encoder_from_jax`` turn a JAX parameter tree (nested dicts of
  numpy arrays, dense kernels stored ``[in, out]``) into this package's
  parameter dicts: dense ``kernel`` [in, out] becomes ``weight`` [out, in]
  (the one transpose, made here and nowhere else), embedding tables and
  biases keep their shape, a MoE layer's expert stacks keep JAX's
  ``[E, in, out]`` (``torch.bmm`` reads them as is), norm parameters stay
  float32.
* :func:`load_pytree` reads the JAX package's ``save_pytree`` directory
  format (``arrays.npz`` + ``manifest.json``, bf16 stored as a uint16 view)
  with numpy alone, so a checkpoint such as ``artifacts/encoder-ck`` loads
  without JAX; :func:`save_pytree` writes the same format, and
  :func:`encoder_to_jax` turns an encoder back into the JAX tree (the one
  transpose undone), so an encoder trained here
  (``eval/train_encoder.py``) loads in the JAX package's ``load_model``;
  :func:`decoder_to_jax` does the same for a llama or MoE decoder.
* :func:`load_model` resolves a checkpoint to (params, config) by the
  family its meta records, as ``sentio_tpu/runtime/weights.py::load_model``
  does, with the same :class:`WeightsError` messages; :func:`load_generator`
  is the generator's (``LLM_CHECKPOINT``: a ``llama`` or ``moe``
  checkpoint); :func:`load_tokenizer` reads the Hugging Face tokenizer
  directory beside a checkpoint (``*_TOKENIZER``, which takes effect only
  with its checkpoint, as in JAX) and refuses one whose vocabulary is
  larger than the model's with JAX's :class:`WeightsError` message.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.moe import MoeConfig
from sentio_tpu_torch.models.tokenizer import HFTokenizer
from sentio_tpu_torch.models.transformer import EncoderConfig

FORMAT_VERSION = 1
_TUPLE_TAG = "__tuple__"
# bfloat16 on numpy (which has none): the bits as a uint16, in a dtype of
# its own so a leaf says what it holds (models/convert.py makes them)
BF16 = np.dtype([("bfloat16", "<u2")])
# a MoE layer's expert stacks: [E, in, out] arrays, not dense-layer dicts
_EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16" or arr.dtype == BF16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _carry(tree: dict, dtype: Optional[torch.dtype], device) -> dict:
    """Recursively convert one JAX subtree. ``dtype`` applies to matrices
    and embedding tables (None keeps the stored dtype), and expert stacks
    keep their layout; norm parameters and other vectors are float32."""
    if "kernel" in tree:
        # the transpose runs where the weights go (on the card, not the host)
        out = {"weight": _tensor(tree["kernel"]).to(device)}
        if "bias" in tree:
            out["bias"] = _tensor(tree["bias"]).to(device)
        if dtype is not None:
            out = {k: v.to(dtype) for k, v in out.items()}
        out["weight"] = out["weight"].transpose(-1, -2).contiguous()
        return out
    if "embedding" in tree:
        table = _tensor(tree["embedding"])
        return {"embedding": (table.to(dtype) if dtype is not None else table).to(device)}
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _carry(value, dtype, device)
        elif key in _EXPERT_STACKS:
            stack = _tensor(value)
            out[key] = (stack.to(dtype) if dtype is not None else stack).to(device)
        else:
            out[key] = _tensor(value).float().to(device)
    return out


def _check_keys(tree: dict, required: tuple[str, ...], family: str) -> None:
    missing = [k for k in required if k not in tree]
    if missing:
        raise ValueError(f"not a {family} parameter tree: missing {missing}")


def llama_from_jax(tree: dict, dtype: Optional[torch.dtype] = None,
                   device="cpu") -> dict:
    _check_keys(tree, ("embed_tokens", "lm_head", "final_norm", "layers_0"), "llama")
    return _carry(tree, dtype, device)


def moe_from_jax(tree: dict, dtype: Optional[torch.dtype] = None,
                 device="cpu") -> dict:
    _check_keys(tree, ("embed_tokens", "lm_head", "final_norm", "layers_0"), "moe")
    _check_keys(tree["layers_0"], ("moe",), "moe")
    return _carry(tree, dtype, device)


def stacked_from_jax(tree: dict, dtype: Optional[torch.dtype] = None,
                     device="cpu") -> dict:
    """A ``stack_layer_params`` tree (either family): the stacked kernels
    ``[L, in, out]`` become the port's ``[L, out, in]`` weights, expert
    stacks ``[L, E, in, out]`` keep their layout."""
    _check_keys(tree, ("embed_tokens", "lm_head", "final_norm", "layers"), "stacked decoder")
    return _carry(tree, dtype, device)


def encoder_from_jax(tree: dict, dtype: Optional[torch.dtype] = None,
                     device="cpu") -> dict:
    _check_keys(tree, ("embed_tokens", "embed_positions", "embed_norm", "layers_0"),
                "encoder")
    return _carry(tree, dtype, device)


def cross_encoder_from_jax(tree: dict, dtype: Optional[torch.dtype] = None,
                           device="cpu") -> dict:
    _check_keys(tree, ("encoder", "head"), "cross-encoder")
    _check_keys(tree["encoder"], ("embed_tokens", "embed_positions", "embed_norm",
                                  "layers_0"), "cross-encoder")
    return _carry(tree, dtype, device)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        # numpy has no bf16: the bits as uint16, as save_pytree stores them
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _to_jax(tree: dict) -> dict:
    """``weight`` [out, in] back to ``kernel`` [in, out]; every other leaf
    (expert stacks included) as it is, detached on the CPU."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _to_jax(value)
        elif key == "weight":
            out["kernel"] = value.detach().cpu().transpose(-1, -2)
        else:
            out[key] = value.detach().cpu()
    return out


def encoder_to_jax(params: dict) -> dict:
    """The inverse of :func:`encoder_from_jax`: the JAX parameter tree, with
    detached tensors in their dtypes as leaves (:func:`save_pytree` writes
    it)."""
    _check_keys(params, ("embed_tokens", "embed_positions", "embed_norm", "layers_0"),
                "encoder")
    return _to_jax(params)


def decoder_to_jax(params: dict) -> dict:
    """The inverse of :func:`llama_from_jax` and :func:`moe_from_jax`."""
    _check_keys(params, ("embed_tokens", "lm_head", "final_norm", "layers_0"), "decoder")
    return _to_jax(params)


def stacked_to_jax(params: dict) -> dict:
    """The inverse of :func:`stacked_from_jax`."""
    _check_keys(params, ("embed_tokens", "lm_head", "final_norm", "layers"), "stacked decoder")
    return _to_jax(params)


# ------------------------------------------------------------ checkpoints


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        flat: dict[str, Any] = {}
        for key in sorted(tree):
            if not isinstance(key, str) or "/" in key or key == _TUPLE_TAG:
                raise ValueError(f"checkpoint key {key!r} is not allowed")
            flat.update(_flatten(tree[key], f"{prefix}{key}/"))
        return flat
    if isinstance(tree, (list, tuple)):
        flat = {}
        for i, value in enumerate(tree):
            flat.update(_flatten(value, f"{prefix}{i}/"))
        return flat
    return {prefix.rstrip("/"): tree}


def _structure_of(tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _structure_of(tree[k], f"{prefix}{k}/") for k in sorted(tree)}
    if isinstance(tree, tuple):
        return {_TUPLE_TAG: [_structure_of(v, f"{prefix}{i}/") for i, v in enumerate(tree)]}
    if isinstance(tree, list):
        return [_structure_of(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix.rstrip("/")


def save_pytree(path, tree: Any, meta: Optional[dict] = None) -> Path:
    """Write ``tree`` (nested dicts / lists of tensors or numpy arrays,
    bf16 as torch tensors or :data:`BF16` arrays) as a
    ``save_pytree`` checkpoint directory — the JAX package's format, which
    both its ``load_pytree`` and :func:`load_pytree` read. Written to a
    temporary directory beside ``path`` and renamed into place, so a crash
    leaves the old checkpoint or the new one."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    keys: dict[str, str] = {}
    for i, (key, leaf) in enumerate(_flatten(tree).items()):
        if isinstance(leaf, torch.Tensor):
            dtypes[key] = "bfloat16" if leaf.dtype == torch.bfloat16 else str(
                _to_numpy(leaf).dtype)
            arr = _to_numpy(leaf)
        else:
            arr = np.asarray(leaf)
            dtypes[key] = str(arr.dtype)
            if arr.dtype == BF16:
                dtypes[key], arr = "bfloat16", arr.view(np.uint16)
        arrays[f"a{i}"] = arr
        keys[f"a{i}"] = key
    manifest = {"format_version": FORMAT_VERSION, "created_unix": time.time(),
                "structure": _structure_of(tree), "keys": keys, "dtypes": dtypes,
                "meta": meta or {}}
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-ckpt-", dir=str(path.parent)))
    try:
        with open(tmp / "arrays.npz", "wb") as f:
            np.savez(f, **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        old = None
        if path.exists():
            old = path.parent / f".old-{path.name}-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _unflatten(flat: dict, structure: Any) -> Any:
    if isinstance(structure, str):
        return flat[structure]
    if isinstance(structure, list):
        return [_unflatten(flat, s) for s in structure]
    if set(structure) == {_TUPLE_TAG}:
        return tuple(_unflatten(flat, s) for s in structure[_TUPLE_TAG])
    return {k: _unflatten(flat, s) for k, s in structure.items()}


def load_pytree(path) -> tuple[Any, dict]:
    """Read a ``save_pytree`` checkpoint directory → (tree of CPU tensors,
    meta). bf16 leaves come back as ``torch.bfloat16``."""
    path = Path(path)
    manifest_path = path / "manifest.json"
    if not manifest_path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    manifest = json.loads(manifest_path.read_text())
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {manifest.get('format_version')}")
    flat: dict[str, torch.Tensor] = {}
    with np.load(path / "arrays.npz", allow_pickle=False) as z:
        for slot, key in manifest["keys"].items():
            arr = z[slot]
            if not arr.flags.writeable:
                arr = arr.copy()
            if manifest["dtypes"][key] == "bfloat16" and arr.dtype == np.uint16:
                flat[key] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                flat[key] = torch.from_numpy(arr)
    return _unflatten(flat, manifest["structure"]), manifest.get("meta", {})


def load_encoder(path, dtype: Optional[torch.dtype] = None,
                 device="cpu") -> tuple[dict, EncoderConfig]:
    """An encoder checkpoint (``meta.family == "encoder"``) → (params, config)."""
    tree, meta = load_pytree(path)
    if meta.get("family") != "encoder":
        raise ValueError(f"{path} is a {meta.get('family')!r} checkpoint, not an encoder")
    return encoder_from_jax(tree, dtype, device), EncoderConfig(**meta["config"])


class WeightsError(Exception):
    pass


# family → (config class, parameter-tree converter)
_FAMILIES = {
    "llama": (LlamaConfig, llama_from_jax),
    "moe": (MoeConfig, moe_from_jax),
    "encoder": (EncoderConfig, encoder_from_jax),
    "cross-encoder": (EncoderConfig, cross_encoder_from_jax),
}


def load_tokenizer(tokenizer_path: str, model_config) -> Optional[HFTokenizer]:
    """The tokenizer directory beside a checkpoint (None for no path), as
    the JAX ``load_model`` loads it: a vocabulary larger than the model's is
    a :class:`WeightsError`."""
    if not tokenizer_path:
        return None
    tokenizer = HFTokenizer(tokenizer_path)
    if tokenizer.vocab_size > model_config.vocab_size:
        raise WeightsError(f"tokenizer at {tokenizer_path!r} has vocab {tokenizer.vocab_size} "
                           f"> model vocab {model_config.vocab_size}")
    return tokenizer


def load_model(path, expect_family: Optional[str] = None,
               dtype: Optional[torch.dtype] = None, device="cpu") -> tuple[dict, Any]:
    """A ``save_pytree`` checkpoint → (params, config): the meta's family
    picks the config class, rebuilt from the meta's recorded config, and the
    converter."""
    try:
        tree, meta = load_pytree(path)
    except (OSError, ValueError, KeyError) as exc:
        raise WeightsError(f"cannot load checkpoint {str(path)!r}: {exc}") from exc
    family = meta.get("family")
    if expect_family and family and family != expect_family:
        raise WeightsError(f"checkpoint {str(path)!r} holds a {family!r} model, "
                           f"expected {expect_family!r}")
    cfg_dict = meta.get("config")
    if not cfg_dict:
        raise WeightsError(f"checkpoint {str(path)!r} has no config in meta")
    lookup = family or expect_family
    if lookup not in _FAMILIES:
        raise WeightsError(f"unknown model family {lookup!r} in {str(path)!r}")
    cfg_cls, convert = _FAMILIES[lookup]
    # JSON stores tuples as lists; frozen configs keep tuples hashable
    fields = {f.name: str(f.type).lower() for f in dataclasses.fields(cfg_cls)}
    kwargs = {k: tuple(v) if isinstance(v, list) and "tuple" in fields[k] else v
              for k, v in cfg_dict.items() if k in fields}
    return convert(tree, dtype, device), cfg_cls(**kwargs)


def load_generator(path, tokenizer_path: str = "", device="cpu"
                   ) -> tuple[dict, LlamaConfig, Optional[HFTokenizer]]:
    """``LLM_CHECKPOINT`` → (params, config, tokenizer or None) of either
    decoder family (a :class:`MoeConfig` for a ``moe`` checkpoint), checked
    as the JAX generator engine checks it: a checkpoint of another family
    is a :class:`WeightsError`; the tokenizer is ``tokenizer_path``'s."""
    params, cfg = load_model(path, device=device)
    tokenizer = load_tokenizer(tokenizer_path, cfg)
    if not isinstance(cfg, LlamaConfig):
        raise WeightsError(f"checkpoint {str(path)!r} holds a {type(cfg).__name__} model "
                           "— the generator engine serves decoder families (llama, moe)")
    return params, cfg, tokenizer


def load_draft(path, device="cpu") -> tuple[dict, LlamaConfig]:
    """``LLM_DRAFT_CHECKPOINT`` → (params, LlamaConfig), loaded as the JAX
    container loads a paged engine's draft (``expect_family="llama"``, so a
    checkpoint of another family, ``moe`` included, is refused). A refusal
    is a :class:`WeightsError` that names the setting before the JAX
    message."""
    try:
        return load_model(path, expect_family="llama", device=device)
    except WeightsError as exc:
        raise WeightsError(f"LLM_DRAFT_CHECKPOINT: {exc}") from exc
