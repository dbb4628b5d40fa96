"""paddle.incubate.autotune, the user's autotune knob. reference:
paddle_tpu/incubate/autotune.py (`set_config` :25, `get_config`,
`status`).

`set_config` takes a dict {"kernel": {"enable": ...}, "layout": {...},
"dataloader": {...}}, a path to such a JSON file, or None (all on). The
"kernel" section switches the port's kernel autotuner (ops/autotune.py);
"layout" and "dataloader" are recorded, as the reference records them.
"""

from __future__ import annotations

import json

from ..ops import autotune as _kernel_autotune

__all__ = ["set_config"]

_config = {"kernel": {"enable": False}, "layout": {"enable": False},
           "dataloader": {"enable": False}}


def set_config(config=None):
    global _config
    if config is None:
        _kernel_autotune.enable_autotune()
        _config = {k: {"enable": True} for k in _config}
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError("set_config expects a dict, a JSON file path, or None")
    for key, val in config.items():
        if key not in _config:
            raise ValueError(f"unknown autotune section {key!r} "
                             "(expected kernel/layout/dataloader)")
        _config[key].update(val)      # a partial config keeps other keys
    # the kernel switch moves only when this call names kernel.enable
    if "enable" in config.get("kernel", {}):
        if _config["kernel"]["enable"]:
            _kernel_autotune.enable_autotune()
        else:
            _kernel_autotune.disable_autotune()


def get_config():
    return {k: dict(v) for k, v in _config.items()}


def status():
    """The kernel cache's statistics."""
    return _kernel_autotune.autotune_status()
