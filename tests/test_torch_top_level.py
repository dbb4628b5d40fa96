"""The port's top level against the JAX package's: the public names of
`paddle_tpu` that `paddle_tpu_torch` lacks are exactly the set below, each
tied to the ROADMAP item that ports it (or to the departure that keeps it
out); the names this slice added behave as the reference's."""

import types
from pathlib import Path

import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt

ROADMAP = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()

# name -> how ROADMAP.md names the item that ports it
MISSING = {
    "static": "`static`", "utils": "`utils`",
    "hub": "`hub`", "onnx": "`onnx`", "sysconfig": "`sysconfig`",
    "version": "`version`",                 # Queue 1 item 2
    "distributed": "`distributed/`",
    "DataParallel": "`DataParallel`",       # Queue 1 item 3
    "Tensor": "`Tensor`",                   # Queue 3, by design
}
# the reference's JAX internals, bound at its top level: no part of the
# user surface
INTERNALS = {"jnp", "execute", "annotations"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_missing_names_are_the_queued_ones():
    assert _public(paddle) - _public(pt) == set(MISSING) | INTERNALS


@pytest.mark.parametrize("name", sorted(MISSING))
def test_each_missing_name_is_queued(name):
    assert MISSING[name] in ROADMAP, name


def test_the_exports_exist():
    for name in pt.__all__:
        assert hasattr(pt, name), name
    for name in pt._MODULES:
        assert isinstance(getattr(pt, name), types.ModuleType), name
    assert pt.base is pt.framework
    assert pt.grad is pt.autograd.grad
    assert pt.Parameter is pt.EagerParamBase
    p = pt.Parameter([1.0, 2.0], "float64", "w", trainable=False)
    assert isinstance(p, torch.nn.Parameter) and p.param_name == "w"
    assert p.dtype == torch.float64 and not p.requires_grad
    lin = pt.nn.Linear(2, 2, device="cpu")
    lin.extra = pt.Parameter(torch.ones(2))
    assert "extra" in dict(lin.named_parameters())
    assert pt.parallel.functional_call is \
        pt.parallel.functional.functional_call
    assert pt.parallel.make_loss_fn is pt.parallel.functional.make_loss_fn


def test_static_mode_switches():
    assert pt.in_dynamic_mode() and paddle.in_dynamic_mode()
    try:
        pt.enable_static()
        assert not pt.in_dynamic_mode()
    finally:
        pt.disable_static()
    assert pt.in_dynamic_mode()
    pt.disable_signal_handler()
    with pt.LazyGuard() as g:
        assert isinstance(g, pt.LazyGuard)


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_as_the_reference(drop_last):
    reader = lambda: iter(range(7))   # noqa: E731
    assert list(pt.batch(reader, 3, drop_last)()) == \
        list(paddle.batch(reader, 3, drop_last)())


@pytest.mark.parametrize("shape,ok", [([2, -1, 3], True), ([2, -2], False),
                                      ([2.0], False), ([torch.tensor(2)],
                                                       True)])
def test_check_shape(shape, ok):
    if ok:
        pt.check_shape(shape)
    else:
        with pytest.raises(ValueError):
            pt.check_shape(shape)
    pt.check_shape(torch.tensor([2, 3]))


def test_set_printoptions():
    try:
        pt.set_printoptions(precision=2, sci_mode=False)
        assert "1.23" in str(torch.tensor([1.23456]))
        assert "1.234" not in str(torch.tensor([1.23456]))
    finally:
        torch.set_printoptions(profile="default")
