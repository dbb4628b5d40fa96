"""Optimizers with a functional core. reference:
paddle_tpu/optimizer/__init__.py (`Optimizer` :33, `SGD` :160, `Momentum`
:204, `Adam` :225, `AdamW` :264).

Every optimizer defines
    init_state(param) -> dict of state tensors
    update(param, grad, state, lr, step)
and, unlike the reference's pure functions, `update` writes the new
parameter and state into the tensors it is given, under
`torch.no_grad()`: at training scale that saves a copy of the parameters
and of every moment. `step()` applies it to the parameters that have a
`.grad`; `tree_init`/`tree_update` apply it over a nested dict of tensors
(the params tree of models.scanned). `SGD`, `Momentum`, `Adam` and
`AdamW` are ported; grad clipping is not. As in the reference's compiled
step, where the learning rate is a float32 array, the step lr * update is
taken in float32 and the parameter rounded once to its own dtype; state
and weight decay stay in the parameter's dtype, a Python scalar rounded to
it first (framework.dtypes.rounded).
"""

from __future__ import annotations

import torch

from ..framework.dtypes import rounded
from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]


def _leaves(tree, *others):
    """(leaf, matching entry of each of `others`) for every tensor of a
    nested dict, in the dict's order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], *(o[k] for o in others))
    else:
        yield (tree, *others)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else \
            float(weight_decay)
        self._accumulators: dict[int, dict] = {}
        self._step_count = 0

    # -- functional core (override) ----------------------------------------
    def init_state(self, p):
        return {}

    def update(self, p, g, state, lr, step):
        raise NotImplementedError

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    # -- stepping ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a grad, in place."""
        self._step_count += 1
        lr_v = self.get_lr()
        for p in self._parameter_list:
            if not p.requires_grad or p.grad is None:
                continue
            st = self._accumulators.get(id(p))
            if st is None:
                st = self._accumulators[id(p)] = self.init_state(p)
            self.update(p, p.grad.to(p.dtype), st, lr_v, self._step_count)

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- state dict ----------------------------------------------------------
    def state_dict(self):
        """{"<param index>_<state name>": tensor, "@step": int} plus the LR
        scheduler's state under "LR_Scheduler"."""
        sd = {}
        for i, p in enumerate(self._parameter_list):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f"{i}_{k}"] = v
        sd["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("@step", 0))
        for i, p in enumerate(self._parameter_list):
            st = self.init_state(p)
            found = False
            for k in st:
                key = f"{i}_{k}"
                if key in state_dict:
                    st[k].copy_(torch.as_tensor(state_dict[key]))
                    found = True
            if found:
                self._accumulators[id(p)] = st
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    # -- over a params tree (the scanned model's training step) -------------
    def tree_init(self, params_tree):
        """The state tree: `init_state` of every leaf."""
        if isinstance(params_tree, dict):
            return {k: self.tree_init(v) for k, v in params_tree.items()}
        return self.init_state(params_tree)

    @torch.no_grad()
    def tree_update(self, params_tree, grads_tree, states_tree, lr_v, step):
        """One update of every leaf, in place; returns the (same) params and
        states trees. Grads are cast to their parameter's dtype first."""
        for p, g, st in _leaves(params_tree, grads_tree, states_tree):
            self.update(p, g.to(p.dtype), st, lr_v, step)
        return params_tree, states_tree


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def update(self, p, g, state, lr, step):
        """p -= lr * (g + weight_decay * p)."""
        if self._weight_decay:
            g = g + rounded(self._weight_decay, g.dtype) * p
        p.sub_(g.float() * lr)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        """v = momentum * v + g (g with weight decay added), then
        p -= lr * v, or with Nesterov p -= lr * (g + momentum * v)."""
        if self._weight_decay:
            g = g + rounded(self._weight_decay, g.dtype) * p
        mu = rounded(self._momentum, g.dtype)
        v = state["velocity"]
        v.mul_(mu).add_(g)
        upd = g + mu * v if self._nesterov else v
        p.sub_(upd.float() * lr)


class Adam(Optimizer):
    """`lazy_mode`, `multi_precision` and `use_multi_tensor` are accepted
    and ignored, as the reference does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._amsgrad = amsgrad
        self._decoupled_wd = False

    def init_state(self, p):
        st = {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}
        if self._amsgrad:
            st["moment2_max"] = torch.zeros_like(p)
        return st

    def update(self, p, g, state, lr, step):
        """The reference's compiled update. The moments update in their own
        dtype (the parameter's), one rounding per operation, with the betas
        rounded to that dtype first, as `b1 * m + (1 - b1) * g` of bf16
        arrays computes in the reference. The bias-corrected step then runs
        in float32 whatever that dtype: there `beta ** step` of a traced
        step is float32. The parameter is written back in its own dtype."""
        b1, b2, eps, wd = self._beta1, self._beta2, self._eps, \
            self._weight_decay
        if wd and not self._decoupled_wd:
            g = g + rounded(wd, g.dtype) * p
        m, v = state["moment1"], state["moment2"]
        m.mul_(rounded(b1, g.dtype)).add_(g * rounded(1 - b1, g.dtype))
        v.mul_(rounded(b2, g.dtype)).add_(
            (g * g).mul_(rounded(1 - b2, g.dtype)))
        if self._amsgrad:
            vmax = state["moment2_max"]
            torch.maximum(vmax, v, out=vmax)
            v = vmax
        denom = (v.float() / (1 - b2 ** step)).sqrt_().add_(eps)
        upd = (m.float() / (1 - b1 ** step)).mul_(lr).div_(denom)
        if wd and self._decoupled_wd:
            upd.add_(p.float() * (lr * wd))
        p.sub_(upd)   # in float32, rounded once to p's dtype


class AdamW(Adam):
    """Decoupled weight decay. reference: python/paddle/optimizer/adamw.py.
    `lr_ratio` and `apply_decay_param_fun` are not ported and raise when
    given."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW: lr_ratio and apply_decay_param_fun are not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name, amsgrad=amsgrad)
        self._decoupled_wd = True
