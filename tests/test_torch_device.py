"""The port's device module, places, dtypes and RNG state against the JAX
package's: what runs without a card (places, listings, the
is_compiled_with_* family, synchronize on the CPU, the dtype objects, the
default dtype, finfo/iinfo, get/set_rng_state). Streams, events and the
memory queries need CUDA: chip_smoke.py's phase 22 times its steps with
`device.Event` and reads its peak memory through `device.cuda`; here they
raise, as there is no CUDA."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as D


def test_places_as_the_reference():
    for name in ("CPUPlace", "CUDAPinnedPlace"):
        assert getattr(pt, name)() == getattr(pt, name)()
    assert pt.CUDAPlace(1) == pt.CUDAPlace(1) != pt.CUDAPlace(0)
    assert pt.CUDAPlace(1).get_device_id() == 1
    assert isinstance(pt.CUDAPinnedPlace(), pt.CPUPlace)
    assert isinstance(pt.XPUPlace(), pt.TPUPlace)
    assert repr(pt.TPUPlace(2)) == repr(paddle.TPUPlace(2)) == "Place(tpu:2)"
    assert len({pt.CUDAPlace(0), pt.CUDAPlace(0), pt.CPUPlace()}) == 2
    with pytest.raises(NotImplementedError):
        D.IPUPlace()


def test_set_device_takes_paddle_names_and_places():
    before = pt.get_device()
    try:
        pt.set_device("gpu:1")
        assert pt.get_device() == "cuda:1"
        pt.set_device(pt.CPUPlace())
        assert pt.get_device() == "cpu"
        assert pt.zeros([2]).device.type == "cpu"
        pt.set_device(pt.CUDAPlace(0))
        assert pt.get_device() == "cuda:0"
        with pytest.raises(ValueError):
            pt.set_device(pt.TPUPlace())
    finally:
        pt.set_device(before)


def test_what_the_build_has():
    assert pt.device_count() == D.cuda.device_count() == \
        torch.cuda.device_count()
    assert pt.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert not pt.is_compiled_with_tpu() and paddle.is_compiled_with_tpu()
    assert not pt.is_compiled_with_xpu() and not D.is_compiled_with_ipu()
    assert not D.is_compiled_with_cinn()
    assert not D.is_compiled_with_custom_device("npu")
    assert D.is_compiled_with_distribute() == \
        torch.distributed.is_available()
    assert D.get_all_device_type()[0] == "cpu"
    assert D.get_available_device()[0] == "cpu"
    assert D.get_all_custom_device_type() == [] == \
        D.get_available_custom_device()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a CPU box")
def test_without_cuda():
    D.synchronize("cpu")
    D.cuda.empty_cache()
    assert not D.cuda.is_available()
    assert D.get_all_device_type() == ["cpu"]
    assert D.get_cudnn_version() is None
    for call in (lambda: D.synchronize(), lambda: D.Stream(),
                 lambda: D.current_stream("cpu"),
                 lambda: D.cuda.max_memory_allocated(),
                 lambda: D.cuda.memory_reserved("cuda:0"), D.Event):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    with D.stream_guard(None):
        pass


def test_dtypes_as_the_reference():
    names = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
             "bfloat16", "float32", "float64", "complex64", "complex128",
             "float8_e4m3fn", "float8_e5m2"]
    for n in names:
        got = getattr(pt, n)
        assert isinstance(got, pt.dtype)
        assert got == (torch.bool if n == "bool" else getattr(torch, n))
        assert np.dtype(getattr(paddle, n)).itemsize == got.itemsize, n
    assert pt.bool8 is torch.bool


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32",
                                  "float64"])
def test_finfo_matches_reference(name):
    got, want = pt.finfo(name), paddle.finfo(name)
    assert got.bits == want.bits
    for key in ("eps", "max", "min", "tiny"):
        assert float(getattr(got, key)) == float(getattr(want, key)), key
    # resolution, 10 ** -digits, is a Python float in torch and a value of
    # the dtype in numpy
    assert got.resolution == pytest.approx(float(want.resolution), rel=0.01)


@pytest.mark.parametrize("name", ["uint8", "int8", "int16", "int32",
                                  "int64"])
def test_iinfo_matches_reference(name):
    got, want = pt.iinfo(getattr(pt, name)), paddle.iinfo(name)
    assert (got.bits, got.min, got.max) == (want.bits, want.min, want.max)


def test_default_dtype():
    assert pt.get_default_dtype() == paddle.get_default_dtype() == "float32"
    try:
        pt.set_default_dtype("float64")
        assert pt.get_default_dtype() == "float64"
        assert pt.zeros([2], device="cpu").dtype == torch.float64
        assert pt.rand([2], device="cpu").dtype == torch.float64
        assert pt.to_tensor([1.5], place="cpu").dtype == torch.float64
        assert pt.arange(0, 1, 0.5, device="cpu").dtype == torch.float64
        assert pt.to_tensor([1], place="cpu").dtype == torch.int64
        with pytest.raises(TypeError):
            pt.set_default_dtype("int32")
    finally:
        pt.set_default_dtype(torch.float32)
    assert pt.ones([1], device="cpu").dtype == torch.float32


def test_rng_state_round_trip():
    pt.seed(3)
    gen = pt.framework.get_generator("cpu")
    torch.rand(2, generator=gen)
    state = pt.get_rng_state()
    a = pt.rand([4], device="cpu")
    b = pt.rand([4], device="cpu")
    pt.set_rng_state(state)
    assert torch.equal(pt.rand([4], device="cpu"), a)
    pt.seed(5)
    pt.set_rng_state(pt.get_rng_state(device="cpu"))
    assert pt.get_rng_state()["seed"] == 5
    assert pt.get_cuda_rng_state()["states"] == {}
    assert pt.set_cuda_rng_state is pt.set_rng_state
    assert not torch.equal(a, b)
