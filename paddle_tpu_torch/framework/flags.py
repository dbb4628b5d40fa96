"""Runtime flag registry. reference: paddle_tpu/framework/flags.py:21-92
(`define_flag`, `set_flags`, `get_flags`, `flag_value`).

A flag's value comes from its default, or from the environment variable
`FLAGS_<name>` when the flag is defined, and is changed with `set_flags`.
Only the flags the port reads are defined. Of the reference's side effects
on set (`_apply_side_effect`, :47-65), the two that configure the port's
own modules are kept: `observability` turns the observability layer on or
off and `fault_injection` arms the fault harness; those that configure JAX
have no counterpart here.
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "set_flags", "get_flags", "flag_value"]

_REGISTRY: dict[str, dict] = {}


def define_flag(name: str, default: Any, help_: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = {"value": value, "default": default, "help": help_}
    return value


def set_flags(flags: dict):
    """paddle.set_flags"""
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _REGISTRY:
            raise ValueError(f"unknown flag FLAGS_{k}")
        _REGISTRY[k]["value"] = v
        _apply_side_effect(k, v)


def _apply_side_effect(name, value):
    if name == "observability":
        from ..observability import disable, enable
        s = str(value).lower()
        if s in ("1", "true", "yes", "on"):
            enable()
        else:
            disable()
    elif name == "fault_injection":
        from ..resilience import faults
        faults.arm_spec(value)   # "" disarms; bad specs raise here


def get_flags(flags):
    """paddle.get_flags"""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        k2 = k.removeprefix("FLAGS_")
        if k2 not in _REGISTRY:
            raise ValueError(f"unknown flag {k}")
        out[k] = _REGISTRY[k2]["value"]
    return out


def flag_value(name: str):
    return _REGISTRY[name]["value"]


# attention backends (reference: flags.py:93, ops/pallas/flash_attention.py
# :735, ops/pallas/attention_router.py:59-68)
define_flag("flash_attention_backend", "auto",
            "auto|pallas|xla for scaled_dot_product_attention on CUDA: "
            "'pallas' takes the flash kernels, 'xla' the dense torch path, "
            "'auto' asks ops/attention_router")
define_flag("flash_attention_bwd", "auto",
            "flash-attention backward: 'pallas' (the K3/K4 kernels), 'xla' "
            "(dense rematerialisation through torch autograd), or 'auto' "
            "(routed per shape by ops/attention_router)")
define_flag("attention_router", "auto",
            "per-shape attention backend selection: 'auto' (ledger, then "
            "a measurement on the live card, then heuristic), 'ledger' "
            "(ledger or heuristic only: never measure), 'heuristic' (legacy "
            "thresholds; ignores the ledger)")
define_flag("attention_ledger_path", "",
            "path of the attention-backend ledger ('' = the "
            "attention_ledger.json shipped next to ops/attention_router.py)")
# observability and resilience (reference: flags.py:131-133)
define_flag("observability", False, "runtime observability layer (paddle_tpu.observability): metrics registry + span tracing + SLO telemetry; off = zero-cost no-op fast path")
define_flag("flight_recorder_dir", "", "directory flight-recorder postmortem dumps land in ('' = the tempdir); read from the environment by observability/recorder.py so standalone loads see it too")
define_flag("fault_injection", "", "chaos harness spec (paddle_tpu.resilience.faults): 'site:nth:Exc' / 'site:rand(p)@seed:Exc' entries joined by ';'; '' = disarmed (one global load per site)")
