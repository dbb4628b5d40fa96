"""paddle.amp.debugging: numerics debugging. reference:
paddle_tpu/amp/debugging.py (`DebugMode`, `TensorCheckerConfig`, the
tensor checker, `check_numerics`, operator stats, `compare_accuracy`,
`check_layer_numerics`).

The reference scans each op's outputs in its one dispatcher
(framework/core.execute) when FLAGS_check_nan_inf is set. The port has no
dispatcher of its own, so setting the flag enters a `TorchDispatchMode`
that scans the floating outputs of every aten op, and clearing it leaves
the mode: with the flag off nothing is installed and nothing is scanned.
The mode is in the thread's dispatch state, which the autograd engine
carries into the threads that run the backward (on CUDA, a thread of its
own per device), so backward ops are scanned too. A hit names the aten op
(`aten.sqrt.default`), not a Paddle op: the port runs torch's operators.

Operator stats count the calls of the ops the AMP layer names
(`amp._cast`, the reference's `_op_observer_hook` slot) with the dtypes
they run in after the cast.
"""

from __future__ import annotations

import contextlib
import enum
import functools
import os
import warnings

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .. import amp as _amp
from ..framework import flags as _flags

__all__ = ["DebugMode", "TensorCheckerConfig", "check_numerics",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "enable_tensor_checker", "disable_tensor_checker",
           "compare_accuracy", "check_layer_numerics"]


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3
    DUMP_ALL = 4
    DUMP_FAIL = 5


class TensorCheckerConfig:
    """Which ops to scan and what to do on a hit."""

    def __init__(self, enable, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


# ops whose outputs are uninitialised memory or no values at all
_UNSCANNED = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "resize_", "set_", "_local_scalar_dense"}


class _NanInfChecker(TorchDispatchMode):
    """Scans the floating outputs of every aten op for NaN/Inf: level 0
    raises RuntimeError naming the op, a higher level warns."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in _UNSCANNED:
            return out
        for t in _pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.numel() == 0 or not (
                    t.is_floating_point() or t.is_complex()):
                continue
            if bool(torch.isfinite(t).all()):
                continue
            n_nan = int(torch.isnan(t).sum())
            msg = (f"check_nan_inf: the output of {func} holds NaN or Inf "
                   f"({n_nan} NaN, {int(torch.isinf(t).sum())} Inf of "
                   f"{t.numel()}, {t.dtype} on {t.device})")
            if _flags.flag_value("check_nan_inf_level") == 0:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return out


_checker: list = [None]


def _sync_checker():
    """Enter the checker's mode when FLAGS_check_nan_inf is set and it is
    not in, leave it when the flag is cleared (set_flags calls this)."""
    on = bool(_flags.flag_value("check_nan_inf"))
    if on and _checker[0] is None:
        mode = _NanInfChecker()
        mode.__enter__()
        _checker[0] = mode
    elif not on and _checker[0] is not None:
        mode, _checker[0] = _checker[0], None
        mode.__exit__(None, None, None)


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """FLAGS_check_nan_inf on: CHECK_NAN_INF_AND_ABORT raises (level 0),
    the other check modes warn (level 1). The DUMP modes, and the op
    lists, output_dir and debug_step, raise NotImplementedError, as in the
    reference: check_numerics dumps one tensor at a time."""
    if not checker_config.enable:
        return
    if checker_config.debug_mode in (DebugMode.DUMP_ALL, DebugMode.DUMP_FAIL):
        raise NotImplementedError(
            "enable_tensor_checker: DUMP modes run through "
            "check_numerics(output_dir=...) per tensor; the global checker "
            "supports the CHECK_* modes")
    for opt, nm in ((checker_config.output_dir, "output_dir"),
                    (checker_config.checked_op_list, "checked_op_list"),
                    (checker_config.skipped_op_list, "skipped_op_list"),
                    (checker_config.debug_step, "debug_step")):
        if opt:
            raise NotImplementedError(
                f"enable_tensor_checker: {nm} is not supported: the checker "
                "scans every op's outputs (use check_numerics for targeted "
                "dumps)")
    level = 0 if checker_config.debug_mode == \
        DebugMode.CHECK_NAN_INF_AND_ABORT else 1
    _flags.set_flags({"check_nan_inf": True, "check_nan_inf_level": level})


def disable_tensor_checker():
    """FLAGS_check_nan_inf off, and the level back to raising."""
    _flags.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                   output_dir=None):
    """Scan one tensor -> (stats, values): stats the int64 [num_nan,
    num_inf, num_zero], values the float32 [max, min, mean] over the
    finite-or-infinite values (NaN skipped; all NaN when every value is
    NaN or there is none), both on the tensor's device. ABORT mode raises
    on a hit; the DUMP modes write the tensor as .npy into output_dir for
    compare_accuracy."""
    t = tensor.detach() if isinstance(tensor, torch.Tensor) else \
        torch.as_tensor(np.asarray(tensor))
    is_float = t.is_floating_point() or t.is_complex()
    num_nan = int(torch.isnan(t).sum()) if is_float else 0
    num_inf = int(torch.isinf(t).sum()) if is_float else 0
    num_zero = int((t == 0).sum())
    hit = num_nan > 0 or num_inf > 0
    if output_dir and (debug_mode == DebugMode.DUMP_ALL
                       or (hit and debug_mode == DebugMode.DUMP_FAIL)):
        os.makedirs(output_dir, exist_ok=True)
        fname = f"{op_type or 'op'}__{var_name or 'var'}.npy"
        a = t.cpu()
        np.save(os.path.join(output_dir, fname),
                (a.float() if a.dtype == torch.bfloat16 else a).numpy())
    if hit and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise RuntimeError(
            f"check_numerics: {op_type or 'tensor'}:{var_name or ''} has "
            f"{num_nan} NaN / {num_inf} Inf values")
    stats = torch.tensor([num_nan, num_inf, num_zero], dtype=torch.int64,
                         device=t.device)
    if t.numel() == 0 or num_nan == t.numel():
        values = torch.full((3,), float("nan"), device=t.device)
    else:
        v = t.reshape(-1)
        if is_float:
            v = v[~torch.isnan(v)]
        v64 = v.double()
        values = torch.stack([v64.max(), v64.min(), v64.mean()]).float()
    return stats, values


# -- operator stats ---------------------------------------------------------

_op_stats: dict | None = None
_nesting = 0


def _observer(name, tensors):
    dtypes = sorted({str(t.dtype).removeprefix("torch.")
                     for t in tensors}) or ["-"]
    key = (name, ",".join(dtypes))
    _op_stats[key] = _op_stats.get(key, 0) + 1


def enable_operator_stats_collection():
    """Count the calls of each op the AMP layer names, per dtype after the
    cast, through `amp._op_observer`. Nested enables share one count;
    only the outermost disable ends it."""
    global _op_stats, _nesting
    if _nesting == 0:
        if _amp._op_observer is not None:
            raise RuntimeError(
                "another operator observer is already installed")
        _op_stats = {}
        _amp._op_observer = _observer
    _nesting += 1


def disable_operator_stats_collection():
    """Stop counting, print the table (op, dtypes, calls) and return it as
    {(op, dtypes): calls}."""
    global _op_stats, _nesting
    if _nesting == 0:
        return {}
    _nesting -= 1
    if _nesting > 0:
        return dict(_op_stats or {})
    _amp._op_observer = None
    stats = dict(_op_stats or {})
    _op_stats = None
    if stats:
        width = max(len(k[0]) for k in stats)
        print(f"{'op':<{width}}  dtypes            calls")
        for (name, dts), n in sorted(stats.items()):
            print(f"{name:<{width}}  {dts:<16}  {n}")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Diff two check_numerics dump directories (.npy per op/var) into a
    CSV report; returns its rows (name, status, max and mean |diff|)."""
    rows = []

    def _ls(p):
        return set(os.listdir(p)) if os.path.isdir(p) else set()

    for fname in sorted(_ls(dump_path) | _ls(another_dump_path)):
        if not fname.endswith(".npy"):
            continue
        pa = os.path.join(dump_path, fname)
        pb = os.path.join(another_dump_path, fname)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            rows.append((fname, "missing", "", ""))
            continue
        a, b = np.load(pa), np.load(pb)
        if a.shape != b.shape:
            rows.append((fname, "shape-mismatch", str(a.shape), str(b.shape)))
            continue
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        rows.append((fname, "ok", f"{diff.max():.6e}", f"{diff.mean():.6e}"))
    with open(output_filename, "w") as f:
        f.write("tensor,status,max_abs_diff,mean_abs_diff\n")
        for r in rows:
            f.write(",".join(r) + "\n")
    return rows


def check_layer_numerics(func):
    """Decorator: run `func` (a layer's forward, or a layer) with the
    tensor checker on."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        prev = _flags.flag_value("check_nan_inf")
        _flags.set_flags({"check_nan_inf": True})
        try:
            return func(*args, **kwargs)
        finally:
            _flags.set_flags({"check_nan_inf": prev})

    return wrapper


_sync_checker()   # FLAGS_check_nan_inf=1 in the environment
