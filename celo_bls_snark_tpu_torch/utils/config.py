"""Typed configuration of the port (the part of the JAX package's
utils/config.py that the ported modules read).

Every tunable lives in one frozen dataclass so a deployment can pin them
in a single place. Every field can be overridden by an environment
variable `CELO_BLS_TPU_<FIELD>` (uppercased, the JAX package's names),
read once at first `get_config()`.

Kernel-shape knobs (msm window/lanes) default to the auto heuristics in
ops/msm.py when None.
"""

import os
from dataclasses import dataclass, fields, replace
from typing import Optional


@dataclass(frozen=True)
class Config:
    msm_window: Optional[int] = None      # Pippenger c (None = _auto_c)
    msm_lanes: Optional[int] = None       # Pippenger L (None = size heuristic)
    fixed_base_window: int = 8            # setup fixed-base table c
    msm_cache_bases: bool = True          # keep prover MSM bases on device
    profile: bool = False                 # print utils.profiling stage times


_CONFIG: Optional[Config] = None

_INT_FIELDS = {"msm_window", "msm_lanes", "fixed_base_window"}


def _from_env(base: Config) -> Config:
    updates = {}
    for f in fields(Config):
        raw = os.environ.get(f"CELO_BLS_TPU_{f.name.upper()}")
        if raw is None:
            continue
        if f.name in _INT_FIELDS:
            updates[f.name] = int(raw)
        else:
            updates[f.name] = raw.lower() in ("1", "true", "yes")
    return replace(base, **updates) if updates else base


def get_config() -> Config:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = _from_env(Config())
    return _CONFIG


def set_config(cfg: Optional[Config]) -> None:
    """Pin the process-wide config (tests / embedding applications);
    None returns to the environment's."""
    global _CONFIG
    _CONFIG = cfg
