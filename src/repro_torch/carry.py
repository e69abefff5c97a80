"""Carry a graph state and its config, an LM's weights and config, or a
GNN's or MIND's, or a training state, between the JAX package and the
port.

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
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import egnn, gatedgcn, mace, nequip
from repro_torch.models.recsys import mind
from repro_torch.optim import compression, optimizer
from repro_torch.tree import tree_map

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
        # np.array, not ascontiguousarray: that one turns a 0-d scalar
        # (n_ccs, gen, overflow) into shape [1]
        a = np.array(arrays[name], FIELDS[name], order="C")
        return torch.from_numpy(a).to(device)

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
# on a leading [L] axis (an MoE layer's 'moe' subtree too: router [L, D, E],
# w_gate / w_up [L, E, D, F], w_down [L, E, F, D], optional 'shared').
# bf16 leaves (numpy's ml_dtypes bfloat16) are read through float32, which
# holds them exactly, and handed back as float32.

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


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
    """An LMConfig from ``dataclasses.asdict`` of either package's (the
    MoE config nested as a dict)."""
    d = dict(d)
    d["dtype"] = _DTYPES[_dtype_name(d["dtype"])]
    if isinstance(d.get("moe"), dict):
        d["moe"] = moe.MoEConfig(**d["moe"])
    return tf.LMConfig(**d)


def _tensor(a, cfg, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=cfg.dtype)


def _arr(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
    def stack(layers):
        first = layers[0]
        return {k: stack([ly[k] for ly in layers]) if isinstance(v, dict)
                else np.stack([_arr(ly[k]) for ly in layers])
                for k, v in first.items()}

    out = {k: _arr(v) for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


# ---------------------------------------------------------------- MIND ---
# MIND's params are five flat arrays in both packages: item_embed [N, D],
# profile_embed [P, D], S [D, D], b_init [L, K] and proj [2D, D].

def mind_config_to_dict(cfg: mind.MINDConfig) -> Dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    return d


def mind_config_from_dict(d: Dict) -> mind.MINDConfig:
    d = dict(d)
    d["dtype"] = _DTYPES[_dtype_name(d["dtype"])]
    return mind.MINDConfig(**d)


def mind_params_from_numpy(tree: Dict, cfg: mind.MINDConfig,
                           device=gs.DEFAULT_DEVICE) -> mind.Params:
    return {k: _tensor(v, cfg, device) for k, v in tree.items()}


def mind_params_to_numpy(params: mind.Params) -> Dict:
    return {k: _arr(v) for k, v in params.items()}


# ----------------------------------------------------------------- GNN ---
# A GNN's params are the JAX pytree as it stands, in both packages: nested
# dicts and lists (an MLP is a list of {'w', 'b'}), the 'layers' subtree's
# leaves stacked on a leading [n_layers] axis.  Its config is the
# dataclass's dict; 'name' says which of the four it is, and the mesh axes
# are names, tuples of names or None in both.

GNN_CONFIGS = {c.name: c for c in (egnn.EGNNConfig, gatedgcn.GatedGCNConfig,
                                    nequip.NequIPConfig, mace.MACEConfig)}
GNN_CONFIG_TYPES = tuple(GNN_CONFIGS.values())


def gnn_config_to_dict(cfg) -> Dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    return d


def gnn_config_from_dict(d: Dict):
    d = dict(d)
    d["dtype"] = _DTYPES[_dtype_name(d["dtype"])]
    return GNN_CONFIGS[d["name"]](**d)


def gnn_params_from_numpy(tree: Dict, cfg, device=gs.DEFAULT_DEVICE) -> Dict:
    return tree_map(lambda a: _tensor(a, cfg, device), tree)


def gnn_params_to_numpy(params: Dict) -> Dict:
    return tree_map(_arr, params)


# ------------------------------------------------------- train state ---
# A trainer's state goes across as {'params', 'opt', 'ef'} in the JAX
# layout: 'opt' with fields m, v (f32 trees shaped as the params) and
# count, 'ef' with field err (an f32 tree) or None; each read by attribute
# (the JAX NamedTuples with numpy leaves) or by key.  The LM's m, v and err
# stack their layers on [L] there, as its params do; a GNN's and MIND's
# are their params' trees in both packages.  The seed ('rng') is
# each package's own and does not cross.

def _field(x, name):
    return x[name] if isinstance(x, dict) else getattr(x, name)


def _tree_from_numpy(tree, cfg, device):
    if isinstance(cfg, tf.LMConfig):
        return lm_params_from_numpy(tree, cfg, device)
    if isinstance(cfg, GNN_CONFIG_TYPES):
        return gnn_params_from_numpy(tree, cfg, device)
    return mind_params_from_numpy(tree, cfg, device)


def _tree_to_numpy(tree) -> Dict:
    if isinstance(tree.get("layers"), list):  # the LM's per-layer dicts
        return lm_params_to_numpy(tree)
    return gnn_params_to_numpy(tree)


def opt_state_from_numpy(opt, cfg, device=gs.DEFAULT_DEVICE
                         ) -> optimizer.OptState:
    """The port's OptState (m and v in f32) from the JAX one in numpy;
    ``cfg`` is the model's (an LMConfig, a GNN config or a MINDConfig)."""
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    return optimizer.OptState(
        m=_tree_from_numpy(_field(opt, "m"), f32, device),
        v=_tree_from_numpy(_field(opt, "v"), f32, device),
        count=torch.tensor(int(np.asarray(_field(opt, "count"))),
                           dtype=torch.int32, device=device))


def opt_state_to_numpy(opt: optimizer.OptState) -> Dict:
    return {"m": _tree_to_numpy(opt.m), "v": _tree_to_numpy(opt.v),
            "count": np.int32(opt.count.item())}


def ef_state_from_numpy(ef, cfg, device=gs.DEFAULT_DEVICE):
    if ef is None:
        return None
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    return compression.EFState(
        err=_tree_from_numpy(_field(ef, "err"), f32, device))


def ef_state_to_numpy(ef):
    return None if ef is None else {"err": _tree_to_numpy(ef.err)}


def train_state_from_numpy(tree: Dict, cfg, device=gs.DEFAULT_DEVICE
                           ) -> Dict:
    """A ``Trainer.state`` from {'params', 'opt', 'ef'} in the JAX layout
    (the seed starts at 0)."""
    return {"params": _tree_from_numpy(tree["params"], cfg, device),
            "opt": opt_state_from_numpy(tree["opt"], cfg, device),
            "ef": ef_state_from_numpy(tree.get("ef"), cfg, device),
            "rng": torch.zeros((), dtype=torch.int64)}


def train_state_to_numpy(state: Dict) -> Dict:
    return {"params": _tree_to_numpy(state["params"]),
            "opt": opt_state_to_numpy(state["opt"]),
            "ef": ef_state_to_numpy(state["ef"])}
