"""Shared driver logic (counterpart of ``qiddm_tpu/cli/common.py``): models
resolved by name through a registry instead of ``eval``."""

from __future__ import annotations

from typing import Sequence

from .. import nn as nn_mod

MODEL_REGISTRY = {
    name: obj
    for name in dir(nn_mod)
    if isinstance(obj := getattr(nn_mod, name), type)
    and issubclass(obj, nn_mod.DenoiserShim)
    and obj is not nn_mod.DenoiserShim
}


def build_model(model_args: Sequence, seed: int = 0, device="cpu"):
    """Instantiate a registered model from a ['Name', arg, ...] list on
    ``device``."""
    name = model_args[0]
    if name not in MODEL_REGISTRY:
        raise SystemExit(f"unknown model {name!r}; ported: "
                         + ", ".join(sorted(MODEL_REGISTRY)))
    params = [int(a) if isinstance(a, str) and a.isdigit() else a
              for a in model_args[1:]]
    return MODEL_REGISTRY[name](*params, seed=seed, device=device)
