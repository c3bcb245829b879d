"""Carry weights into the port.

* ``llama_from_jax`` / ``encoder_from_jax`` / ``cross_encoder_from_jax``
  turn a JAX parameter tree (nested dicts of numpy arrays, dense kernels
  stored ``[in, out]``) into this package's parameter dicts: dense
  ``kernel`` [in, out] becomes ``weight`` [out, in] (the one transpose, made
  here and nowhere else), embedding tables and biases keep their shape,
  norm parameters stay float32.
* :func:`load_pytree` reads the JAX package's ``save_pytree`` directory
  format (``arrays.npz`` + ``manifest.json``, bf16 stored as a uint16 view)
  with numpy alone, so a checkpoint such as ``artifacts/encoder-ck`` loads
  without JAX; :func:`save_pytree` writes the same format, and
  :func:`encoder_to_jax` turns an encoder back into the JAX tree (the one
  transpose undone), so an encoder trained here
  (``eval/train_encoder.py``) loads in the JAX package's ``load_model``.
* :func:`load_model` resolves a checkpoint to (params, config) by the
  family its meta records, as ``sentio_tpu/runtime/weights.py::load_model``
  does, with the same :class:`WeightsError` messages; :func:`load_llama`
  is the generator's (``LLM_CHECKPOINT``). A ``moe`` checkpoint and every
  tokenizer path raise ``NotImplementedError``: MoE serving is not ported,
  and the JAX package's tokenizer for a path needs ``transformers``.
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
from sentio_tpu_torch.models.transformer import EncoderConfig

FORMAT_VERSION = 1
_TUPLE_TAG = "__tuple__"


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _carry(tree: dict, dtype: Optional[torch.dtype], device) -> dict:
    """Recursively convert one JAX subtree. ``dtype`` applies to matrices
    and embedding tables (None keeps the stored dtype); norm parameters
    and other vectors are float32."""
    if "kernel" in tree:
        out = {"weight": _tensor(tree["kernel"]).t().contiguous()}
        if "bias" in tree:
            out["bias"] = _tensor(tree["bias"])
        if dtype is not None:
            out = {k: v.to(dtype) for k, v in out.items()}
        return {k: v.to(device) for k, v in out.items()}
    if "embedding" in tree:
        table = _tensor(tree["embedding"])
        return {"embedding": (table.to(dtype) if dtype is not None else table).to(device)}
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _carry(value, dtype, device)
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


def encoder_to_jax(params: dict) -> dict:
    """The inverse of :func:`encoder_from_jax`: ``weight`` [out, in] back to
    ``kernel`` [in, out] — the JAX parameter tree, with detached tensors in
    their dtypes as leaves (:func:`save_pytree` writes it)."""
    _check_keys(params, ("embed_tokens", "embed_positions", "embed_norm", "layers_0"),
                "encoder")

    def back(tree: dict) -> dict:
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = back(value)
            elif key == "weight":
                out["kernel"] = value.detach().cpu().t()
            else:
                out[key] = value.detach().cpu()
        return out

    return back(params)


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
    """Write ``tree`` (nested dicts / lists of tensors or numpy arrays) as a
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
            if manifest["dtypes"][key] == "bfloat16" and arr.dtype == np.uint16:
                flat[key] = torch.from_numpy(arr.copy()).view(torch.bfloat16)
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
    "encoder": (EncoderConfig, encoder_from_jax),
    "cross-encoder": (EncoderConfig, cross_encoder_from_jax),
}


def refuse_tokenizer(setting: str, path: str) -> None:
    """A ``*_TOKENIZER`` path names a Hugging Face tokenizer directory; the
    JAX package loads it through ``transformers``, which this package does
    not use."""
    if path:
        raise NotImplementedError(f"{setting}={path!r}: tokenizers other than the byte "
                                  "tokenizer are not ported")


def load_model(path, expect_family: Optional[str] = None, setting: str = "checkpoint",
               dtype: Optional[torch.dtype] = None, device="cpu") -> tuple[dict, Any]:
    """A ``save_pytree`` checkpoint → (params, config): the meta's family
    picks the config class, rebuilt from the meta's recorded config, and the
    converter. ``setting`` names the setting in the ``NotImplementedError``
    a ``moe`` checkpoint raises."""
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
    if lookup == "moe":
        raise NotImplementedError(f"{setting}={str(path)!r} holds a 'moe' model: MoE "
                                  "serving is not ported")
    if lookup not in _FAMILIES:
        raise WeightsError(f"unknown model family {lookup!r} in {str(path)!r}")
    cfg_cls, convert = _FAMILIES[lookup]
    # JSON stores tuples as lists; frozen configs keep tuples hashable
    fields = {f.name: str(f.type).lower() for f in dataclasses.fields(cfg_cls)}
    kwargs = {k: tuple(v) if isinstance(v, list) and "tuple" in fields[k] else v
              for k, v in cfg_dict.items() if k in fields}
    return convert(tree, dtype, device), cfg_cls(**kwargs)


def load_llama(path, tokenizer_path: str = "", device="cpu") -> tuple[dict, LlamaConfig]:
    """``LLM_CHECKPOINT`` → (params, LlamaConfig), checked as the JAX
    generator engine checks it: a checkpoint of another family is a
    :class:`WeightsError`."""
    refuse_tokenizer("LLM_TOKENIZER", tokenizer_path)
    params, cfg = load_model(path, setting="LLM_CHECKPOINT", device=device)
    if not isinstance(cfg, LlamaConfig):
        raise WeightsError(f"checkpoint {str(path)!r} holds a {type(cfg).__name__} model "
                           "— the generator engine serves decoder families (llama, moe)")
    return params, cfg


def load_draft(path, device="cpu") -> tuple[dict, LlamaConfig]:
    """``LLM_DRAFT_CHECKPOINT`` → (params, LlamaConfig), loaded as the JAX
    container loads a paged engine's draft (``expect_family="llama"``, so a
    checkpoint of another family, ``moe`` included, is refused). A refusal
    is a :class:`WeightsError` that names the setting before the JAX
    message."""
    try:
        return load_model(path, expect_family="llama", setting="LLM_DRAFT_CHECKPOINT",
                          device=device)
    except WeightsError as exc:
        raise WeightsError(f"LLM_DRAFT_CHECKPOINT: {exc}") from exc
