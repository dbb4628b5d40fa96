"""paddle.distributed.io. reference: paddle_tpu/distributed/io.py —
persistables save/load for distributed training, through the port's
framework.io_file."""

from __future__ import annotations

import os

__all__ = ["save_persistables", "load_persistables",
           "is_persistable"]


def is_persistable(var):
    return getattr(var, "persistable", False)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Save every persistable parameter of the program/layer."""
    target = main_program
    state = {}
    if target is not None and hasattr(target, "state_dict"):
        state = target.state_dict()
    os.makedirs(dirname, exist_ok=True)
    from ..framework.io_file import save
    save(state, os.path.join(dirname, filename or "persistables.pdparams"))


def load_persistables(executor, dirname, main_program=None, filename=None):
    from ..framework.io_file import load
    path = os.path.join(dirname, filename or "persistables.pdparams")
    state = load(path)
    if main_program is not None and hasattr(main_program, "set_state_dict"):
        main_program.set_state_dict(state)
    return state
