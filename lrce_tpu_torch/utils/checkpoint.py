"""Checkpoint save / load, counterpart of ``lrce_tpu/utils/checkpoint.py``.

The port writes torch files: ``torch.save`` of {'model_state_dict': ...,
['optimizer_state_dict', 'scheduler_state_dict']} with the reference's key
names, under the reference's file-naming convention, so
``lrce_tpu.utils.checkpoint.load_checkpoint`` ingests them through its
torch converters. It reads both formats behind the shared ``.pt`` suffix:
torch zips directly, and lrce_tpu's native pickles (a pytree of numpy
arrays) through ``utils/convert.state_dict_from_jax``. Optimizer state is
each framework's own; a native pickle's optimizer moments are not
converted.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import torch

from lrce_tpu_torch.utils.convert import state_dict_from_jax, unwrap_state_dict
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def map_tensors(tree: Any, fn) -> Any:
    """``tree`` (nested dicts / lists / tuples) with ``fn`` applied to every
    tensor, everything else kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def _to_host(tree: Any) -> Any:
    return map_tensors(tree, lambda t: t.detach().cpu())


def save_checkpoint(path: str, model_state: dict, optimizer_state: Any = None,
                    scheduler_state: Optional[dict] = None) -> None:
    """Write the checkpoint to ``path`` through ``path + '.tmp'`` and a
    rename, so a reader never sees half a file. Tensors are copied to the
    host first."""
    ckpt = {"model_state_dict": _to_host(model_state)}
    if optimizer_state is not None:
        ckpt["optimizer_state_dict"] = _to_host(optimizer_state)
    if scheduler_state is not None:
        ckpt["scheduler_state_dict"] = scheduler_state
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def _corrupt(path: str, cause: Exception) -> RuntimeError:
    err = RuntimeError(
        f"{path} is neither a loadable torch checkpoint nor a native lrce_tpu "
        "pickle: the file is likely truncated or corrupt.")
    err.__cause__ = cause
    return err


def _load_torch(path: str, device) -> dict:
    ckpt = torch.load(path, map_location=device, weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        return ckpt
    return {"model_state_dict": dict(unwrap_state_dict(ckpt))}


def load_checkpoint(path: str, device=DEFAULT_DEVICE) -> dict:
    """Load a checkpoint onto ``device`` (the card unless the caller asks
    for the CPU): {'model_state_dict': reference-named tensors, ...}.

    Torch zips start with 'PK'; pickles (lrce_tpu's native format, or a
    legacy non-zip torch file) with the pickle protocol byte. A native
    pickle is read with ``pickle`` (load only files this project wrote) and
    its model pytree converted to the port's names; its optimizer state
    stays behind. A file that neither reader takes raises a RuntimeError
    that names it as truncated or corrupt."""
    device = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic[:1] != b"\x80":
        try:
            return _load_torch(path, device)
        except (RuntimeError, pickle.UnpicklingError, EOFError, OSError,
                ValueError) as e:
            raise _corrupt(path, e) from e
    native_err: Exception
    try:
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
            out = dict(ckpt)
            out.pop("optimizer_state_dict", None)
            sd = state_dict_from_jax(ckpt["model_state_dict"])
            out["model_state_dict"] = {k: v.to(device) for k, v in sd.items()}
            return out
        native_err = RuntimeError(
            f"unpickled to {type(ckpt).__name__} without a "
            "'model_state_dict' key")
    except Exception as e:  # noqa: BLE001 - any failure: try the torch reader
        native_err = e
    try:
        return _load_torch(path, device)
    except Exception:  # noqa: BLE001 - both readers failed: report corruption
        raise _corrupt(path, native_err) from native_err


def checkpoint_name(epoch: int, loss: float, metric: float) -> str:
    """Reference naming: epoch{N:02}_loss{L:.4f}_metric{M:.4f}.pt."""
    return f"epoch{epoch:02}_loss{loss:.4f}_metric{metric:.4f}.pt"
