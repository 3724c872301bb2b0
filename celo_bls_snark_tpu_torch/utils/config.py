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
    compat_sign_bit: int = 377            # hash-to-curve compat y-sign bit
    # Prove-side arkworks byte-parity mode. This build's circuit is leaner
    # than the deployed Celo constraint system (18,439 constraints per
    # in-circuit BLS verify against the reference's 18,702,
    # crates/bls-gadgets/src/bls.rs:401), so proofs made here verify only
    # under keys set up here; verify-side interop is exact. True makes
    # setup and prove fail fast instead of producing keys that are not
    # byte-compatible with a deployed Celo ceremony.
    ark_parity: bool = False
    profile: bool = False                 # print utils.profiling stage times
    profile_trace_dir: Optional[str] = None  # utils.profiling.device_trace output


_CONFIG: Optional[Config] = None

_INT_FIELDS = {"msm_window", "msm_lanes", "fixed_base_window", "compat_sign_bit"}
_BOOL_FIELDS = {"profile", "msm_cache_bases", "ark_parity"}
_STR_FIELDS = {"profile_trace_dir"}


def _from_env(base: Config) -> Config:
    updates = {}
    for f in fields(Config):
        raw = os.environ.get(f"CELO_BLS_TPU_{f.name.upper()}")
        if raw is None:
            continue
        if f.name in _INT_FIELDS:
            updates[f.name] = int(raw)
        elif f.name in _BOOL_FIELDS:
            updates[f.name] = raw.lower() in ("1", "true", "yes")
        elif f.name in _STR_FIELDS:
            updates[f.name] = raw
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
