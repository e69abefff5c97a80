"""Carry a graph state and its config, or an LM's weights and config,
between the JAX package and the port.

The state is handed over as a flat dict of numpy arrays (the JAX
``GraphState`` leaves, with the edge table's columns as ``src``, ``dst``
and ``state``) and the config as a dict of ``GraphConfig`` fields, so both
packages can start from one state; an LM goes across the same way (below).
Nothing here imports JAX; callers turn JAX arrays into numpy first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.models import transformer as tf

# numpy dtype of every leaf, as the JAX package stores it
FIELDS = {"v_alive": np.bool_, "ccid": np.int32, "src": np.int32,
          "dst": np.int32, "state": np.int8, "n_ccs": np.int32,
          "gen": np.int32, "overflow": np.int32}


def config_from_dict(d: Dict) -> gs.GraphConfig:
    return gs.GraphConfig(**d)


def config_to_dict(cfg: gs.GraphConfig) -> Dict:
    return dataclasses.asdict(cfg)


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device=gs.DEFAULT_DEVICE) -> gs.GraphState:
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")

    def t(name):
        a = np.ascontiguousarray(np.asarray(arrays[name], FIELDS[name]))
        return torch.from_numpy(a.copy()).to(device)

    return gs.GraphState(
        v_alive=t("v_alive"), ccid=t("ccid"),
        edges=et.EdgeTable(src=t("src"), dst=t("dst"), state=t("state")),
        n_ccs=t("n_ccs"), gen=t("gen"), overflow=t("overflow"))


def state_to_numpy(state: gs.GraphState) -> Dict[str, np.ndarray]:
    leaves = {"v_alive": state.v_alive, "ccid": state.ccid,
              "src": state.edges.src, "dst": state.edges.dst,
              "state": state.edges.state, "n_ccs": state.n_ccs,
              "gen": state.gen, "overflow": state.overflow}
    return {k: v.cpu().numpy().astype(FIELDS[k]) for k, v in leaves.items()}


# ------------------------------------------------------------------ LM ---
# The LM's weights are handed over as the JAX params pytree in numpy:
# 'embed', 'ln_f', optional 'lm_head', and 'layers' whose leaves are stacked
# on a leading [L] axis.  bf16 leaves (numpy's ml_dtypes bfloat16) are read
# through float32, which holds them exactly, and handed back as float32.

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name  # a numpy or JAX scalar type


def lm_config_to_dict(cfg: tf.LMConfig) -> Dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    return d


def lm_config_from_dict(d: Dict) -> tf.LMConfig:
    d = dict(d)
    d["dtype"] = _DTYPES[_dtype_name(d["dtype"])]
    return tf.LMConfig(**d)


def _tensor(a, cfg: tf.LMConfig, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=cfg.dtype)


def lm_params_from_numpy(tree: Dict, cfg: tf.LMConfig,
                         device=gs.DEFAULT_DEVICE) -> tf.Params:
    """The port's params (per-layer dicts) from the JAX params pytree."""
    def layer(sub, l):
        return {k: layer(v, l) if isinstance(v, dict) else
                _tensor(v[l], cfg, device) for k, v in sub.items()}

    out = {k: _tensor(tree[k], cfg, device) for k in
           ("embed", "ln_f", "lm_head") if k in tree}
    out["layers"] = [layer(tree["layers"], l) for l in range(cfg.n_layers)]
    return out


def lm_params_to_numpy(params: tf.Params) -> Dict:
    """The JAX params pytree layout, layers stacked on [L], as numpy."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(layers):
        first = layers[0]
        return {k: stack([ly[k] for ly in layers]) if isinstance(v, dict)
                else np.stack([arr(ly[k]) for ly in layers])
                for k, v in first.items()}

    out = {k: arr(v) for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out
