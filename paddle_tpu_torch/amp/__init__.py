"""AMP: automatic mixed precision as a dtype policy. reference:
paddle_tpu/amp/__init__.py (:26-229; python/paddle/amp/auto_cast.py,
grad_scaler.py, amp_lists.py).

O1 is a per-op cast hook. The reference casts at its single dispatch
point (framework/core.py:544-545), keyed by each op's name; the port has
no such dispatch, so each of its functionals that the reference runs under
a name of WHITE_LIST or BLACK_LIST passes its tensor inputs through
`_cast(name, ...)` first, in the reference's order (F.linear as "linear",
F.conv2d as "conv2d", F.batch_norm as "batch_norm", F.cross_entropy as
"cross_entropy", ...). Under `auto_cast`, a white op's float32 inputs
become the AMP dtype and a black op's float16/bfloat16 inputs float32;
nothing else is cast, and an op the reference runs without a listed name
is not cast in the port either. The port does not use `torch.autocast`,
whose lists differ. Autograd carries each cast back, so a float32
parameter gets a float32 gradient. O2 (`decorate`) casts the parameters
themselves.
"""

from __future__ import annotations

import contextlib

import torch

from ..framework.dtypes import convert_dtype

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "is_float16_supported", "is_bfloat16_supported",
           "white_list", "black_list"]

# reference: python/paddle/amp/amp_lists.py
WHITE_LIST = {
    "matmul", "mm", "bmm", "linear", "fused_matmul_bias", "conv1d",
    "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "scaled_dot_product_attention", "flash_attention_pallas", "rnn", "lstm",
    "gru", "addmm", "mv",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "c_softmax_with_cross_entropy", "layer_norm", "norm",
    "batch_norm", "group_norm", "instance_norm", "rms_norm", "logsumexp",
    "erf", "erfinv", "pow", "log_softmax", "log_sigmoid", "bce",
    "bce_with_logits", "nll_loss", "kl_div", "l1_loss", "mse_loss",
    "smooth_l1_loss", "ctc_loss",
}
_HALF = (torch.float16, torch.bfloat16)


def white_list():
    return {"float16": {"O1": WHITE_LIST, "O2": WHITE_LIST},
            "bfloat16": {"O1": WHITE_LIST, "O2": WHITE_LIST}}


def black_list():
    return {"float16": {"O1": BLACK_LIST, "O2": BLACK_LIST},
            "bfloat16": {"O1": BLACK_LIST, "O2": BLACK_LIST}}


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()
# called as _op_observer(name, tensors) with every hooked op's inputs after
# the cast (the reference's framework.core._op_observer_hook)
_op_observer = None


def _cast(name, *tensors):
    """The reference's `_cast_hook` over the tensor inputs of the op called
    `name` (None passes through); returns them as a tuple."""
    if _state.enabled:
        if name in (WHITE_LIST | _state.custom_white) - _state.custom_black:
            tensors = tuple(t.to(_state.dtype) if t is not None
                            and t.dtype == torch.float32 else t
                            for t in tensors)
        elif name in BLACK_LIST | _state.custom_black:
            tensors = tuple(t.float() if t is not None and t.dtype in _HALF
                            else t for t in tensors)
    if _op_observer is not None:
        _op_observer(name, [t for t in tensors if t is not None])
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """reference: python/paddle/amp/auto_cast.py:auto_cast."""
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = enable
    _state.dtype = convert_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast every float32 parameter to `dtype` in place, except those
    of batch norms and LayerNorm. The parameters keep their identity, so
    an optimizer built earlier still holds them. reference:
    python/paddle/amp/auto_cast.py:decorate."""
    from ..nn.layer.norm import LayerNorm, _BatchNormBase
    target = convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, (_BatchNormBase, LayerNorm)):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.dtype == torch.float32:
                        p.data = p.data.to(target)
    model = models if isinstance(models, (list, tuple)) else model_list[0]
    return model if optimizers is None else (model, optimizers)


amp_decorate = decorate


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


class GradScaler:
    """Dynamic loss scaling. reference: python/paddle/amp/grad_scaler.py,
    with the JAX package's dynamics (:142-229): the scale falls by
    decr_ratio (not below 1) after decr_every_n_nan_or_inf steps with a
    non-finite gradient, which are skipped, and rises by incr_ratio after
    incr_every_n_steps finite ones. `unscale_` multiplies every gradient
    by 1 / scale in place and asks the device once whether any of them
    holds an inf or a NaN (the reference asks once per parameter; the
    result is the same)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        for g in grads:
            g.mul_(inv)
        self._found_inf = bool(grads) and not bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        # the reference's contract (amp/grad_scaler.py:261): the caller has
        # already run scaled_loss.backward(); minimize only unscales,
        # steps if the gradients are finite, and updates the scale
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def state_dict(self):
        return {"scale": self._scale, "good": self._good_steps,
                "bad": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good", 0)
        self._bad_steps = sd.get("bad", 0)
