"""paddle.hub. reference: paddle_tpu/hub.py (`list`, `help`, `load`),
after python/paddle/hapi/hub.py. Only source='local' works: a directory
holding a hubconf.py; the github and gitee sources raise, as the
reference's do, since they need the network."""

from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUBCONF} in {repo_dir}")
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    return mod


def _check_source(source):
    if source != "local":
        raise RuntimeError(
            f"hub source {source!r} needs the network; use source='local' "
            "with a directory containing hubconf.py")


def _entry(repo_dir, model):
    mod = _load_hubconf(repo_dir)
    fn = getattr(mod, model, None)
    if fn is None:
        raise ValueError(f"{model} not found in {repo_dir}/{_HUBCONF}")
    return fn


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    """The entry points a repo's hubconf.py exposes."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [k for k, v in vars(mod).items()
            if callable(v) and not k.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    _check_source(source)
    return _entry(repo_dir, model).__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    _check_source(source)
    return _entry(repo_dir, model)(**kwargs)
