"""Architecture registry of the port: the dense LM archs and the paper's
SMSCC engine config.  ``get(name)`` returns the module; each exposes
FAMILY and config(), and the LM archs also SHAPES and smoke_config()."""
from __future__ import annotations

import importlib

ARCHS = ["h2o_danube_3_4b", "qwen3_14b", "gemma3_12b", "smscc"]


def get(name: str):
    mod = name.replace("-", "_")
    if mod not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")
