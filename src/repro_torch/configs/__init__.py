"""Architecture registry of the port: the LM archs (dense and MoE), the
four GNNs, MIND and the paper's SMSCC engine config.  ``get(name)``
returns the module; each exposes FAMILY, SHAPES, config() and
smoke_config()."""
from __future__ import annotations

import importlib

ARCHS = ["moonshot_v1_16b_a3b", "qwen3_moe_235b_a22b", "h2o_danube_3_4b",
         "qwen3_14b", "gemma3_12b", "mace", "egnn", "nequip", "gatedgcn",
         "mind", "smscc"]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get(name: str):
    mod = ALIASES.get(name, name).replace("-", "_")
    if mod not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def all_archs(include_paper: bool = True):
    return ARCHS if include_paper else [a for a in ARCHS if a != "smscc"]
