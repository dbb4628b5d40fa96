"""Helpers of the vision-zoo parity tests (tests/test_torch_vision_zoo*.py):
the port's vision models against the JAX package's on the same weights.

Weights: the reference's own initializers draw every parameter with a
separately compiled JAX op, which takes 10-25 s a model on the CPU
(densenet121, googlenet). So each case draws its weights once with the
port's initializers (the reference's distributions: Uniform(+-1/sqrt(fan
in)) convolutions, XavierUniform linears, unit batch norms), as one
reference-format state of numpy arrays: the port takes it through
`convert.load_reference_state`, the reference as the params of its
jitted `functional_call` (or its tensors' data), and the reference model
itself is built with its initializers giving zeros.

Tolerances are tests/test_torch_vision.py's. float32 results are held to
the reference within F32_TOL, or within three times the port's own
float32 error against a float64 copy of it where that is larger (training
mode's batch norms over the few values a channel of the last stages at
these sizes); gradients within GRAD_TOL of their tensor's largest
|value|, or three times the port's own float32 error.

Gradients are compared in float64 on both sides: the port's model cast
to float64 against the reference's jax.grad in JAX's x64 mode, with the
reference's batch norms taking their statistics at float64 too (its code
casts them to float32; for this call its `jnp` reads float32 as float64).
In float32, training-mode batch norms at random initialisation make these
deep nets' backward ill-conditioned: the reference's own float32
gradients of the early layers part from its float64 ones by more than
GRAD_TOL, and so do two float64 runs that round only their statistics
to float32 in different summation orders. In float64 the two packages
agree inside GRAD_TOL.
"""

import contextlib
import copy
import inspect

import numpy as np
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn import Dropout as JDropout
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.nn import initializer as JI
from paddle_tpu.parallel.functional import functional_call as jcall
from paddle_tpu.parallel.functional import make_loss_fn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import seed as pseed
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.nn import Dropout as PDropout
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import models as pmodels

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2

_INITS = [c for c in vars(JI).values()
          if inspect.isclass(c) and "_init" in vars(c)]


@contextlib.contextmanager
def zero_reference_init():
    """The reference's initializers give numpy zeros: nothing drawn, nothing
    compiled."""
    saved = {c: vars(c)["_init"] for c in _INITS}
    try:
        for c in _INITS:
            c._init = lambda self, shape, dtype: np.zeros(shape, dtype)
        yield
    finally:
        for c, f in saved.items():
            c._init = f


def reference_model(name, **kw):
    with zero_reference_init():
        return getattr(jmodels, name)(**kw)


def case(name, seed=0, **kw):
    """(reference, port, np_state) of vision/models' `name`: np_state drawn
    by the port's initializers from `seed`, carried into a port model built
    from another seed."""
    pseed(seed)
    src = getattr(pmodels, name)(device="cpu", **kw)
    np_state = {k: v.detach().numpy().copy()
                for k, v in src.state_dict().items()}
    pseed(seed + 1)
    port = getattr(pmodels, name)(device="cpu", **kw)
    load_reference_state(port, np_state)
    return reference_model(name, **kw), port, np_state


def images(seed=0, b=4, hw=32):
    rs = np.random.RandomState(seed)
    return rs.randn(b, 3, hw, hw).astype(np.float32), rs.randint(0, 10, (b,))


def set_mode(model, training):
    """Training or eval mode, with every dropout layer in eval mode (the
    two sides' masks would differ)."""
    if training:
        model.train()
    else:
        model.eval()
    subs = (model.named_sublayers(include_self=True)
            if hasattr(model, "named_sublayers") else model.named_modules())
    for _, m in subs:
        if isinstance(m, (JDropout, PDropout)):
            m.eval()


def main_head(out):
    """GoogLeNet's (main, aux1, aux2) -> main; other outputs as they are."""
    return out[0] if isinstance(out, tuple) else out


def ref_forward(ref, np_state, x, training, dtype=jnp.float32):
    """The reference's jitted functional forward of x (batch statistics in
    training mode, its buffers left as they are) as numpy float32, every
    output of a tuple."""
    set_mode(ref, training)
    params = {k: jnp.asarray(v, dtype) for k, v in np_state.items()}
    fn = jax.jit(lambda p, a: jcall(ref, p, a, training=training))
    out = fn(params, jnp.asarray(x, dtype))
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


def port_forward(port, x, training, dtype=torch.float32):
    set_mode(port, training)
    with torch.no_grad():
        out = port(torch.as_tensor(x).to(dtype))
    outs = out if isinstance(out, tuple) else (out,)
    return [o.float().numpy() for o in outs]


def f64_error(port, x, training):
    """The largest |difference| between the port's float32 outputs of x
    and a float64 copy's: how far float32 rounding alone moves them."""
    twin = copy.deepcopy(port).double()
    got = port_forward(port, x, training)
    exact = port_forward(twin, np.asarray(x, np.float64), training,
                         torch.float64)
    return max(np.abs(g - e).max() for g, e in zip(got, exact))


def check_logits(name, x, training, **kw):
    """Every output of `name` in training or eval mode against the
    reference's."""
    ref, port, np_state = case(name, **kw)
    want = ref_forward(ref, np_state, x, training)
    got = port_forward(port, x, training)
    tol = max(F32_TOL, 3 * f64_error(port, x, training))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=tol)


class _Wide:
    """jax.numpy with float32 read as float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def wide_reference_batch_norm():
    """The reference's batch norm takes its statistics in float64."""
    saved = jnorm.jnp
    jnorm.jnp = _Wide()
    try:
        yield
    finally:
        jnorm.jnp = saved


def ref_loss_and_grads(ref, np_state, x, y):
    """The cross-entropy of the reference's main head in training mode
    (dropout off), through its `make_loss_fn` (bench.py's loss; the first
    output of a tuple), and its gradient for every entry of the state
    (zero for the buffers), by jax.grad in float64 all through."""
    set_mode(ref, True)
    with jax.enable_x64(True), wide_reference_batch_norm():
        params = {k: jnp.asarray(v, jnp.float64) for k, v in np_state.items()}
        batch = (jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.int32))
        loss_fn = make_loss_fn(ref, lambda logits, t: JF.cross_entropy(
            logits, t))
        value, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, batch, None).astype(jnp.float64)))(params)
        return float(value), {k: np.asarray(v) for k, v in grads.items()}


def check_grads(name, x, y, **kw):
    """The loss and every parameter's gradient of the port's float64 copy
    against the reference's float64 jax.grad; the port's float32 loss and
    gradients finite."""
    ref, port, np_state = case(name, **kw)
    want_loss, want = ref_loss_and_grads(ref, np_state, x, y)
    set_mode(port, True)
    twin = copy.deepcopy(port).double()
    loss = PF.cross_entropy(main_head(port(torch.as_tensor(x))),
                            torch.as_tensor(y))
    loss.backward()
    exact = PF.cross_entropy(main_head(twin(torch.as_tensor(x).double())),
                             torch.as_tensor(y))
    exact.backward()
    assert abs(exact.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert np.isfinite(loss.item())
    n = 0
    for (k, p), q in zip(port.named_parameters(), twin.parameters()):
        if q.grad is None:      # off the loss's path: an aux head
            assert p.grad is None and not np.any(want[k]), k
            continue
        assert torch.isfinite(p.grad).all(), k
        tol = GRAD_TOL * max(np.abs(want[k]).max(), 1e-3)
        np.testing.assert_allclose(q.grad.numpy(), want[k], rtol=0,
                                   atol=tol, err_msg=k)
        n += 1
    assert n > 0
