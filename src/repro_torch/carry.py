"""Carry a graph state and its config between the JAX package and the port.

The state is handed over as a flat dict of numpy arrays (the JAX
``GraphState`` leaves, with the edge table's columns as ``src``, ``dst``
and ``state``) and the config as a dict of ``GraphConfig`` fields.  Both
packages can then start from one state: this is what the port carries
across in place of weights.  Nothing here imports JAX; callers turn JAX
arrays into numpy first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import edge_table as et
from repro_torch.core import graph_state as gs

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
