"""Optimizers with a functional core. reference:
paddle_tpu/optimizer/__init__.py (`Optimizer` :33-158, then `SGD`, `ASGD`,
`Momentum`, `Adam`, `AdamW`, `Adagrad`, `Adadelta`, `Adamax`, `RMSProp`,
`Lamb`, `NAdam`, `RAdam`, `Rprop` and `LBFGS`, :160-529).

Every optimizer but LBFGS defines
    init_state(param) -> dict of state tensors
    update(param, grad, state, lr, step)
and, unlike the reference's pure functions, `update` writes the new
parameter and state into the tensors it is given, under
`torch.no_grad()`: at training scale that saves a copy of the parameters
and of every moment. `step()` applies it to the parameters that have a
`.grad`, after `grad_clip` (nn/clip.py) and at lr times the parameter's
`optimize_attr["learning_rate"]` (framework/param_attr.py);
`tree_init`/`tree_update` apply it over a nested dict of tensors (the
params tree of models.scanned). As in the reference's compiled step, where
the learning rate is a float32 array, the step lr * update is taken in
float32 and the parameter rounded once to its own dtype; state and weight
decay stay in the parameter's dtype, a Python scalar rounded to it first
(framework.dtypes.rounded). `weight_decay` takes a float, `L2Decay` or
`L1Decay`; like the reference, both objects add coeff * p to the gradient.
"""

from __future__ import annotations

import math

import torch

from ..framework.dtypes import rounded
from . import lr
from .lr import LRScheduler

__all__ = ["ASGD", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "Adagrad", "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam",
           "RAdam", "Rprop", "LBFGS", "lr"]


def _leaves(tree, *others):
    """(leaf, matching entry of each of `others`) for every tensor of a
    nested dict, in the dict's order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], *(o[k] for o in others))
    else:
        yield (tree, *others)


def _decay(g, p, wd):
    """g + wd * p in g's dtype (the L2/L1 decay every optimizer but AdamW
    and Lamb folds into the gradient)."""
    return g + rounded(wd, g.dtype) * p if wd else g


def _ema(state, x, beta):
    """state = beta * state + (1 - beta) * x in place, in state's dtype."""
    return state.mul_(rounded(beta, state.dtype)).add_(
        x * rounded(1 - beta, state.dtype))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = 0.0 if weight_decay is None else \
            float(getattr(weight_decay, "_coeff", weight_decay))
        self._accumulators: dict[int, dict] = {}
        self._step_count = 0

    # -- functional core (override) ----------------------------------------
    def init_state(self, p):
        return {}

    def update(self, p, g, state, lr, step):
        raise NotImplementedError

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- stepping ------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a grad, in place. The
        clip's gradients are new tensors: `p.grad` stays as it was."""
        self._step_count += 1
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr_v = self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            st = self._accumulators.get(id(p))
            if st is None:
                st = self._accumulators[id(p)] = self.init_state(p)
            p_lr = lr_v * getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)
            self.update(p, g.to(p.dtype), st, p_lr, self._step_count)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict ----------------------------------------------------------
    def _key(self, i, p, k):
        return f"{getattr(p, 'param_name', None) or i}_{k}"

    def state_dict(self):
        """The reference's keys: {"<ParamAttr name or param index>_<state
        name>":
        tensor, "@step": int}, plus the LR scheduler's state under
        "LR_Scheduler"."""
        sd = {}
        for i, p in enumerate(self._parameter_list):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[self._key(i, p, k)] = v
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
                key = self._key(i, p, k)
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
        p.sub_(_decay(g, p, self._weight_decay).float() * lr)


class ASGD(Optimizer):
    """Averaged SGD: the step is lr times the mean of the last `batch_num`
    gradients (`d`, their running sum, and `ys`, the window)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = batch_num

    def init_state(self, p):
        return {"d": torch.zeros_like(p),
                "ys": p.new_zeros((self._batch_num,) + tuple(p.shape))}

    def update(self, p, g, state, lr, step):
        """Evict the window's oldest gradient from d, admit g, then
        p -= lr * d / min(step, batch_num)."""
        g = _decay(g, p, self._weight_decay)
        d, ys = state["d"], state["ys"]
        idx = (step - 1) % self._batch_num
        d.sub_(ys[idx]).add_(g)
        ys[idx] = g
        n = float(max(min(step, self._batch_num), 1))
        p.sub_(d.float() * lr / n)


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
        g = _decay(g, p, self._weight_decay)
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
        if not self._decoupled_wd:
            g = _decay(g, p, wd)
        m, v = state["moment1"], state["moment2"]
        _ema(m, g, b1)
        _ema(v, g * g, b2)
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
    As in the reference (optimizer/__init__.py:264-274), `lr_ratio` is
    accepted and dropped, and `apply_decay_param_fun` is kept as
    `_apply_decay_fn` and never read: every parameter is decayed."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name, amsgrad=amsgrad)
        self._decoupled_wd = True
        self._apply_decay_fn = apply_decay_param_fun


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def update(self, p, g, state, lr, step):
        """acc += g * g; p -= lr * g / (sqrt(acc) + eps)."""
        g = _decay(g, p, self._weight_decay)
        acc = state["moment"].add_(g * g)
        p.sub_((g.float() * lr).div_(acc.float().sqrt().add_(self._eps)))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._rho = rho

    def init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        """E[g^2] and E[dx^2] as decaying means at rho; the update
        g * sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) in the parameter's
        dtype, p -= lr * update."""
        g = _decay(g, p, self._weight_decay)
        rho, eps = self._rho, rounded(self._eps, g.dtype)
        asg, asu = state["avg_squared_grad"], state["avg_squared_update"]
        _ema(asg, g * g, rho)
        upd = g * (asu + eps).sqrt_() / (asg + eps).sqrt_()
        _ema(asu, upd * upd, rho)
        p.sub_(upd.float() * lr)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        """m as Adam's; u = max(beta2 * u, |g|);
        p -= lr / (1 - beta1^step) * m / (u + eps)."""
        g = _decay(g, p, self._weight_decay)
        m, u = state["moment"], state["inf_norm"]
        _ema(m, g, self._beta1)
        torch.maximum(u.mul_(rounded(self._beta2, u.dtype)), g.abs(), out=u)
        p.sub_((m.float() * (lr / (1 - self._beta1 ** step))).div_(
            u.float() + self._eps))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum = momentum
        self._centered = centered

    def init_state(self, p):
        st = {"mean_square": torch.zeros_like(p),
              "velocity": torch.zeros_like(p)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p)
        return st

    def update(self, p, g, state, lr, step):
        """ms (and, centered, mg) as decaying means at rho;
        v = momentum * v + lr * g / sqrt(ms [- mg^2] + eps); p -= v. The
        velocity holds lr, as the reference's does."""
        g = _decay(g, p, self._weight_decay)
        rho = self._rho
        ms = _ema(state["mean_square"], g * g, rho)
        if self._centered:
            mg = _ema(state["mean_grad"], g, rho)
            denom = (ms - mg * mg).float().add_(self._eps).sqrt_()
        else:
            denom = (ms.float() + self._eps).sqrt_()
        v = state["velocity"]
        v.mul_(rounded(self._momentum, v.dtype)).add_(
            (g.float() * lr).div_(denom).to(v.dtype))
        p.sub_(v)


class Lamb(Optimizer):
    """Adam's direction plus lamb_weight_decay * p, scaled by the trust
    ratio ||p|| / ||r|| (each in float32). `exclude_from_weight_decay_fn`
    is kept and never read, as in the reference: every parameter is
    decayed."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = _ema(state["moment1"], g, b1)
        v = _ema(state["moment2"], g * g, b2)
        r = (m / rounded(1 - b1 ** step, m.dtype)) / (
            (v / rounded(1 - b2 ** step, v.dtype)).sqrt_()
            + rounded(self._eps, v.dtype))
        r = r + rounded(self._weight_decay, r.dtype) * p
        w_norm = torch.linalg.vector_norm(p.float())
        r_norm = torch.linalg.vector_norm(r.float())
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm)).to(p.dtype)
        p.sub_(r.float() * (trust.float() * lr))


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def init_state(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=p.device)}

    def update(self, p, g, state, lr, step):
        """Adam with Nesterov momentum whose coefficient mu_t decays
        (momentum_decay); the running product of the mu_t in float32."""
        g = _decay(g, p, self._weight_decay)
        b1 = self._beta1
        mu_t = b1 * (1 - 0.5 * 0.96 ** (step * self._psi))
        mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((step + 1) * self._psi))
        mu_prod = state["mu_product"].mul_(mu_t)
        m = _ema(state["moment1"], g, b1)
        v = _ema(state["moment2"], g * g, self._beta2)
        mhat = (m.float() * mu_t1 / (1 - mu_prod * mu_t1)
                + g.float() * (1 - mu_t) / (1 - mu_prod))
        denom = (v.float() / (1 - self._beta2 ** step)).sqrt_().add_(
            self._eps)
        p.sub_((mhat * lr).div_(denom))


class RAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_state(self, p):
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p)}

    def update(self, p, g, state, lr, step):
        """Adam with the variance rectified: while the approximated SMA
        length rho_t is at most 5, the step is lr * m_hat alone."""
        g = _decay(g, p, self._weight_decay)
        b1, b2 = self._beta1, self._beta2
        m = _ema(state["moment1"], g, b1)
        v = _ema(state["moment2"], g * g, b2)
        upd = m.float() / (1 - b1 ** step) * lr
        rho_inf = 2 / (1 - b2) - 1
        rho_t = rho_inf - 2 * step * b2 ** step / (1 - b2 ** step)
        if rho_t > 5:
            r_t = ((rho_t - 4) * (rho_t - 2) * rho_inf
                   / ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
            l_t = math.sqrt(1 - b2 ** step) / (v.float().sqrt() + self._eps)
            upd = upd.mul_(r_t).mul_(l_t)
        p.sub_(upd)


class Rprop(Optimizer):
    """Resilient backprop: a step size per element (state "lr", from the
    learning rate at the first step), grown by etas[1] while the
    gradient's sign holds and cut by etas[0] when it flips, within
    learning_rate_range; the parameter moves by the step size against the
    gradient's sign, and not at all where the sign just flipped."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def init_state(self, p):
        return {"prev_grad": torch.zeros_like(p),
                "lr": torch.full_like(p, self.get_lr())}

    def update(self, p, g, state, lr, step):
        sign = torch.sign(g * state["prev_grad"])
        one = torch.ones_like(g)
        eta = torch.where(sign > 0, one * self._etas[1],
                          torch.where(sign < 0, one * self._etas[0], one))
        step_lr = state["lr"]
        step_lr.mul_(eta).clamp_(self._lr_range[0], self._lr_range[1])
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        state["prev_grad"].copy_(g_eff)
        p.sub_(step_lr * torch.sign(g_eff))


class LBFGS(Optimizer):
    """reference: python/paddle/optimizer/lbfgs.py. `step(closure)`, where
    the closure computes the loss and its gradients, takes one
    quasi-Newton step from the last `history_size` curvature pairs (the
    two-loop recursion over flat float32 vectors), then calls the closure
    again at the new point to record the next pair."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = max_iter
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        self._history = []

    def _flat(self, grads):
        return torch.cat([(p.grad if grads else p).detach().reshape(-1)
                          .float() for p in self._parameter_list])

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS requires a closure")
        with torch.enable_grad():
            loss = closure()
        with torch.no_grad():
            g, x = self._flat(True), self._flat(False)
            q = g
            alphas = []
            for s, y, rho in reversed(self._history):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if self._history:
                s, y, _ = self._history[-1]
                q = torch.dot(s, y) / torch.dot(y, y).clamp(min=1e-10) * q
            for (s, y, rho), a in zip(self._history, reversed(alphas)):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            x_new = x + self.get_lr() * -q
            offset = 0
            for p in self._parameter_list:
                n = p.numel()
                p.copy_(x_new[offset:offset + n].reshape(p.shape))
                offset += n
                p.grad = None
        with torch.enable_grad():
            closure()
        with torch.no_grad():
            s_vec, y_vec = x_new - x, self._flat(True) - g
            sy = torch.dot(s_vec, y_vec)
            if float(sy) > 1e-10:
                self._history.append((s_vec, y_vec, 1.0 / sy))
                if len(self._history) > self.history_size:
                    self._history.pop(0)
        return loss
