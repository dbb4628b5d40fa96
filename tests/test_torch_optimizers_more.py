"""The port's optimizers, grad clipping, decay objects and ParamAttr
against the JAX package's.

- Every optimizer of the reference (the ten slice 2 left, and SGD,
  Momentum, Adam and AdamW with each kind of weight decay) takes a few
  eager `step()`s on the same float32 parameters and gradients in both
  packages; the parameters must agree within F32_TOL. RAdam runs at
  beta2 0.9 for 7 steps, so that its rectified branch (rho_t > 5) is
  taken from step 6 on.
- `tree_update` of each new optimizer over a two-leaf params tree against
  the reference's.
- ClipGradByValue, ClipGradByNorm and ClipGradByGlobalNorm inside an SGD
  step, and the global norm itself, within F32_TOL; the port leaves
  `p.grad` as it was. clip_grad_norm_ (orders 2, 1 and inf) and
  clip_grad_value_ rewrite the gradients as the reference's do.
- ParamAttr: a learning rate per parameter (`optimize_attr`), trainable,
  name, initializer; `set_lr` (which raises under a scheduler),
  `set_lr_scheduler` and `minimize`.
- LBFGS with a closure on a quadratic, three steps.
- A state dict saved by one package (`save`) loads in the other (`load`,
  `set_state_dict`) and the next step agrees, the LR scheduler's state
  included.
- AdamW with lr_ratio and apply_decay_param_fun: it constructs and steps
  in the port (it raised before) and, as the reference does, decays every
  parameter.

F32_TOL is a few float32 roundings of values of order 1: the two
packages round the same formulas, but not always in the same order (a sum
of squares, a norm, a sqrt of a Python float in double or in float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.core import Parameter as JParam, Tensor as JTensor
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt

F32_TOL = 2e-5
SHAPES = [(5, 3), (7,)]


def _problem(seed, steps):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _run_ref(ctor, params, grads, **kw):
    ps = [JParam(jnp.asarray(a)) for a in params]
    opt = ctor(parameters=ps, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = JTensor(jnp.asarray(g))
        opt.step()
    return [np.asarray(p._data) for p in ps], opt


def _run_port(ctor, params, grads, **kw):
    ps = [torch.nn.Parameter(torch.tensor(a)) for a in params]
    opt = ctor(parameters=ps, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.tensor(g)
        opt.step()
    return [p.detach().numpy() for p in ps], opt


def _close(got, want, tol=F32_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


CASES = {
    "asgd": ("ASGD", dict(learning_rate=0.1, batch_num=2,
                          weight_decay=0.01), 3),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1), 3),
    "adagrad_decay": ("Adagrad", dict(learning_rate=0.1,
                                      weight_decay=0.05), 3),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9), 3),
    "adamax": ("Adamax", dict(learning_rate=0.05, weight_decay=0.01), 3),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, rho=0.9), 3),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, rho=0.9,
                                         momentum=0.9, centered=True), 3),
    "lamb": ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.01), 3),
    "nadam": ("NAdam", dict(learning_rate=0.05, weight_decay=0.01), 3),
    "radam": ("RAdam", dict(learning_rate=0.05, beta2=0.9), 7),
    "radam_unrectified": ("RAdam", dict(learning_rate=0.05), 3),
    "rprop": ("Rprop", dict(learning_rate=0.01), 4),
    "sgd_l2": ("SGD", dict(learning_rate=0.1), 3),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.1,
                                           use_nesterov=True), 3),
    "adam_amsgrad": ("Adam", dict(learning_rate=0.05, amsgrad=True), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_reference(case):
    name, kw, steps = CASES[case]
    params, grads = _problem(1, steps)
    want, _ = _run_ref(getattr(jopt, name), params, grads, **kw)
    got, _ = _run_port(getattr(popt, name), params, grads, **kw)
    _close(got, want)


@pytest.mark.parametrize("decay", ["float", "L1Decay", "L2Decay"])
@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_weight_decay_forms(name, decay):
    """A float, L1Decay and L2Decay: coeff * p added to the gradient
    (decoupled in AdamW), L1Decay as coeff * p too, as in the
    reference."""
    params, grads = _problem(2, 3)
    obj = {"float": (0.05, 0.05),
           "L1Decay": (paddle.L1Decay(0.05), pt.L1Decay(0.05)),
           "L2Decay": (paddle.L2Decay(0.05), pt.L2Decay(0.05))}[decay]
    want, _ = _run_ref(getattr(jopt, name), params, grads,
                       learning_rate=0.05, weight_decay=obj[0])
    got, _ = _run_port(getattr(popt, name), params, grads,
                       learning_rate=0.05, weight_decay=obj[1])
    _close(got, want)


@pytest.mark.parametrize("name", ["ASGD", "Adagrad", "Adadelta", "Adamax",
                                  "RMSProp", "Lamb", "NAdam", "RAdam",
                                  "Rprop"])
def test_tree_update_matches_reference(name):
    kw = {"learning_rate": 0.05}
    if name == "RMSProp":
        kw.update(centered=True, momentum=0.5)
    params, grads = _problem(3, 3)
    ref = getattr(jopt, name)(parameters=[], **kw)
    port = getattr(popt, name)(parameters=[], **kw)
    jtree = {"a": jnp.asarray(params[0]), "b": {"c": jnp.asarray(params[1])}}
    ttree = {"a": torch.tensor(params[0]),
             "b": {"c": torch.tensor(params[1])}}
    jst, tst = ref.tree_init(jtree), port.tree_init(ttree)
    for i, gs in enumerate(grads, 1):
        jg = {"a": jnp.asarray(gs[0]), "b": {"c": jnp.asarray(gs[1])}}
        tg = {"a": torch.tensor(gs[0]), "b": {"c": torch.tensor(gs[1])}}
        jtree, jst = ref.tree_update(jtree, jg, jst, 0.05, i)
        ttree, tst = port.tree_update(ttree, tg, tst, 0.05, i)
    _close([ttree["a"].numpy(), ttree["b"]["c"].numpy()],
           [np.asarray(jtree["a"]), np.asarray(jtree["b"]["c"])])


# -- clipping ----------------------------------------------------------------

CLIPS = {"value": ("ClipGradByValue", (0.5,)),
         "norm": ("ClipGradByNorm", (1.0,)),
         "global_norm": ("ClipGradByGlobalNorm", (1.0,))}


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_in_step_matches_reference(kind):
    name, args = CLIPS[kind]
    params, grads = _problem(4, 2)
    grads = [[3 * g for g in gs] for gs in grads]     # every clip acts
    want, _ = _run_ref(jopt.SGD, params, grads, learning_rate=0.1,
                       grad_clip=getattr(jnn, name)(*args))
    got, opt = _run_port(popt.SGD, params, grads, learning_rate=0.1,
                         grad_clip=getattr(pnn, name)(*args))
    _close(got, want)
    for p, g in zip(opt._parameter_list, grads[-1]):
        np.testing.assert_array_equal(p.grad.numpy(), g)   # left as given


def test_global_norm_matches_reference():
    _, grads = _problem(5, 1)
    clip = pnn.ClipGradByGlobalNorm(1.0)
    got = clip.global_norm([torch.tensor(g) for g in grads[0]])
    want = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in grads[0]))
    np.testing.assert_allclose(float(got), want, rtol=F32_TOL)
    ref = jnn.ClipGradByGlobalNorm(1.0)([(None, JTensor(jnp.asarray(g)))
                                         for g in grads[0]])
    port = clip([(None, torch.tensor(g)) for g in grads[0]])
    _close([g.numpy() for _, g in port], [np.asarray(g._data)
                                          for _, g in ref])


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    params, grads = _problem(6, 1)
    jps = [JParam(jnp.asarray(a)) for a in params]
    tps = [torch.nn.Parameter(torch.tensor(a)) for a in params]
    for jp, tp, g in zip(jps, tps, grads[0]):
        jp.grad = JTensor(jnp.asarray(g))
        tp.grad = torch.tensor(g)
    want = jnn.clip_grad_norm_(jps, 1.5, norm_type)
    got = pnn.clip_grad_norm_(tps, 1.5, norm_type)
    np.testing.assert_allclose(float(got), float(np.asarray(want._data)),
                               rtol=F32_TOL)
    _close([p.grad.numpy() for p in tps],
           [np.asarray(p.grad._data) for p in jps])
    jnn.clip_grad_value_(jps, 0.1)
    pnn.clip_grad_value_(tps, 0.1)
    _close([p.grad.numpy() for p in tps],
           [np.asarray(p.grad._data) for p in jps])


# -- ParamAttr and the lr API ------------------------------------------------

def _linears(attr_kw, bias_kw=None):
    ref = jnn.Linear(4, 3, weight_attr=paddle.ParamAttr(**attr_kw),
                     bias_attr=paddle.ParamAttr(**(bias_kw or {})))
    port = pnn.Linear(4, 3, weight_attr=pt.ParamAttr(**attr_kw),
                      bias_attr=pt.ParamAttr(**(bias_kw or {})),
                      device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.tensor(np.asarray(ref.weight._data)))
        port.bias.copy_(torch.tensor(np.asarray(ref.bias._data)))
    return ref, port


def test_param_attr_learning_rate_name_trainable_initializer():
    ref, port = _linears(dict(learning_rate=0.5, name="w0"),
                         dict(learning_rate=2.0))
    assert port.weight.optimize_attr == ref.weight.optimize_attr \
        == {"learning_rate": 0.5}
    assert port.bias.optimize_attr == {"learning_rate": 2.0}
    assert port.weight.param_name == ref.weight.name == "w0"
    rng = np.random.RandomState(7)
    gw = rng.randn(4, 3).astype(np.float32)
    gb = rng.randn(3).astype(np.float32)
    ref.weight.grad, ref.bias.grad = JTensor(gw), JTensor(gb)
    port.weight.grad, port.bias.grad = torch.tensor(gw), torch.tensor(gb)
    jopt.SGD(0.1, parameters=ref.parameters()).step()
    popt.SGD(0.1, parameters=port.parameters()).step()
    _close([port.weight.detach().numpy(), port.bias.detach().numpy()],
           [np.asarray(ref.weight._data), np.asarray(ref.bias._data)])
    frozen = pnn.Linear(2, 2, weight_attr=pt.ParamAttr(trainable=False),
                        device="cpu")
    assert not frozen.weight.requires_grad and frozen.bias.requires_grad
    const = pnn.Linear(2, 2, weight_attr=pt.ParamAttr(
        initializer=pnn.initializer.Constant(0.25)), device="cpu")
    assert torch.all(const.weight == 0.25)
    assert pnn.Linear(2, 2, bias_attr=False, device="cpu").bias is None


def test_set_lr_set_lr_scheduler_and_minimize():
    params, grads = _problem(8, 2)
    results = []
    for opt_mod, lr_mod, mk_param, mk_grad, read in (
            (jopt, jopt.lr, lambda a: JParam(jnp.asarray(a)),
             lambda g: JTensor(jnp.asarray(g)),
             lambda p: np.asarray(p._data)),
            (popt, popt.lr, lambda a: torch.nn.Parameter(torch.tensor(a)),
             torch.tensor, lambda p: p.detach().numpy().copy())):
        ps = [mk_param(a) for a in params]
        opt = opt_mod.SGD(0.1, parameters=ps)
        opt.set_lr(0.05)
        assert opt.get_lr() == 0.05
        for p, g in zip(ps, grads[0]):
            p.grad = mk_grad(g)
        opt.step()
        sched = lr_mod.StepDecay(0.2, step_size=1, gamma=0.5)
        opt.set_lr_scheduler(sched)
        with pytest.raises(RuntimeError):
            opt.set_lr(0.3)
        sched.step()
        for p, g in zip(ps, grads[1]):
            p.grad = mk_grad(g)
        opt.step()
        results.append([read(p) for p in ps])
    _close(results[1], results[0])

    # minimize: backward, step, clear_grad
    x = np.random.RandomState(9).randn(6, 4).astype(np.float32)
    ref, port = _linears({})
    jo = jopt.SGD(0.1, parameters=ref.parameters())
    to = popt.SGD(0.1, parameters=port.parameters())
    assert jo.minimize((ref(paddle.to_tensor(x)) ** 2).mean()) == \
        to.minimize((port(torch.tensor(x)) ** 2).mean()) == (None, None)
    assert port.weight.grad is None
    _close([port.weight.detach().numpy()], [np.asarray(ref.weight._data)])


def test_lbfgs_with_closure_matches_reference():
    rng = np.random.RandomState(10)
    m = rng.randn(6, 6).astype(np.float32)
    a = (m @ m.T / 6 + np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    x0 = rng.randn(6).astype(np.float32)

    jx = JParam(jnp.asarray(x0))
    jo = jopt.LBFGS(learning_rate=0.5, parameters=[jx])
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)

    def jclosure():
        jo.clear_grad()
        loss = 0.5 * (jx * paddle.matmul(ja, jx)).sum() - (jb * jx).sum()
        loss.backward()
        return loss

    tx = torch.nn.Parameter(torch.tensor(x0))
    to = popt.LBFGS(learning_rate=0.5, parameters=[tx])
    ta, tb = torch.tensor(a), torch.tensor(b)

    def tclosure():
        to.clear_grad()
        loss = 0.5 * (tx * (ta @ tx)).sum() - (tb * tx).sum()
        loss.backward()
        return loss

    for _ in range(3):
        jl, tl = jo.step(jclosure), to.step(tclosure)
        np.testing.assert_allclose(float(tl), float(np.asarray(jl._data)),
                                   rtol=F32_TOL, atol=F32_TOL)
    _close([tx.detach().numpy()], [np.asarray(jx._data)])
    with pytest.raises(ValueError):
        to.step()


# -- state dicts across packages ---------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_dict_loads_across_packages(writer, tmp_path):
    params, grads = _problem(11, 3)
    path = str(tmp_path / "opt.pdopt")
    mk = dict(reference=(jopt, paddle, lambda a: JParam(jnp.asarray(a)),
                         lambda g: JTensor(jnp.asarray(g)),
                         lambda p: np.asarray(p._data)),
              port=(popt, pt, lambda a: torch.nn.Parameter(torch.tensor(a)),
                    torch.tensor, lambda p: p.detach().numpy().copy()))
    reader = "port" if writer == "reference" else "reference"
    w_opt, w_pkg, w_param, w_grad, w_read = mk[writer]
    r_opt, r_pkg, r_param, r_grad, r_read = mk[reader]
    ps = [w_param(a) for a in params]
    opt = w_opt.Adam(w_opt.lr.StepDecay(0.05, step_size=1, gamma=0.5),
                     parameters=ps)
    for gs in grads[:2]:
        for p, g in zip(ps, gs):
            p.grad = w_grad(g)
        opt.step()
        opt._learning_rate.step()
    w_pkg.save(opt.state_dict(), path)
    mid = [w_read(p) for p in ps]
    for p, g in zip(ps, grads[2]):
        p.grad = w_grad(g)
    opt.step()

    qs = [r_param(a) for a in mid]
    opt2 = r_opt.Adam(r_opt.lr.StepDecay(0.05, step_size=1, gamma=0.5),
                      parameters=qs)
    opt2.set_state_dict(r_pkg.load(path))
    assert opt2._step_count == 2 and opt2._learning_rate.last_epoch == 2
    for q, g in zip(qs, grads[2]):
        q.grad = r_grad(g)
    opt2.step()
    _close([r_read(q) for q in qs], [w_read(p) for p in ps])


# -- the repaired fault ------------------------------------------------------

def test_adamw_lr_ratio_and_apply_decay_param_fun():
    """PaddleNLP's recipe: AdamW(..., lr_ratio=..., apply_decay_param_fun=
    <no bias>). The port raised NotImplementedError for both; the
    reference takes them and decays every parameter."""
    params, grads = _problem(12, 3)
    kw = dict(learning_rate=0.05, weight_decay=0.1,
              lr_ratio=lambda p: 0.5,
              apply_decay_param_fun=lambda n: "bias" not in n)
    want, _ = _run_ref(jopt.AdamW, params, grads, **kw)
    got, opt = _run_port(popt.AdamW, params, grads, **kw)
    _close(got, want)
    plain, _ = _run_port(popt.AdamW, params, grads, learning_rate=0.05,
                         weight_decay=0.1)
    _close(got, plain, 0.0)              # every parameter decayed
    assert opt._apply_decay_fn is kw["apply_decay_param_fun"]
