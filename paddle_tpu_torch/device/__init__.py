"""paddle.device over torch.cuda. reference: paddle_tpu/device/__init__.py
(171 lines): the places and device listings, `Stream`, `Event`,
`current_stream`, `stream_guard`, `set_stream`, `synchronize`, the `cuda`
namespace and the `is_compiled_with_*` family.

Where the reference's streams and events are stand-ins (XLA orders a TPU's
work itself), the port's are torch.cuda's: work is queued on a stream,
an event is recorded on one and times the work between two. A call that
names no device acts on the port's default device (CUDA unless
`set_device` says otherwise); on the CPU `synchronize` has nothing to wait
for, and a stream or an event raises, as there is none.
"""

from __future__ import annotations

import contextlib

import torch

from ..framework.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, TPUPlace, XPUPlace,
    cuda_device_count, device_count, get_device, is_compiled_with_cuda,
    is_compiled_with_tpu, is_compiled_with_xpu, resolve_device, set_device)

__all__ = ["set_device", "get_device", "device_count", "Place", "CPUPlace",
           "TPUPlace", "CUDAPlace", "CUDAPinnedPlace", "XPUPlace",
           "is_compiled_with_cuda", "is_compiled_with_xpu",
           "is_compiled_with_tpu", "cuda_device_count", "Stream", "Event",
           "current_stream", "stream_guard", "synchronize", "set_stream",
           "cuda", "IPUPlace", "is_compiled_with_rocm",
           "is_compiled_with_ipu", "is_compiled_with_cinn",
           "is_compiled_with_distribute", "is_compiled_with_custom_device",
           "get_cudnn_version", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device"]


def _cuda(device=None) -> torch.device:
    """The CUDA device `device` names (the default device without one);
    raises for a CPU device or where there is no CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"streams and events are CUDA's; {dev} has none")
    return dev


class Stream:
    """A CUDA stream (torch.cuda.Stream). Paddle's priority 1 is high, 2
    (the default) normal."""

    def __init__(self, device=None, priority=2, *, stream=None):
        self.stream = stream if stream is not None else torch.cuda.Stream(
            device=_cuda(device), priority=-1 if priority == 1 else 0)
        self.device = self.stream.device

    def synchronize(self):
        self.stream.synchronize()

    def query(self) -> bool:
        return self.stream.query()

    def wait_stream(self, stream):
        self.stream.wait_stream(stream.stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def wait_event(self, event):
        self.stream.wait_event(event.event)


class Event:
    """A CUDA event (torch.cuda.Event); with enable_timing,
    `elapsed_time(end)` gives the milliseconds between two."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self.event = torch.cuda.Event(enable_timing=enable_timing,
                                      blocking=blocking,
                                      interprocess=interprocess)

    def record(self, stream=None):
        self.event.record(None if stream is None else stream.stream)

    def query(self) -> bool:
        return self.event.query()

    def synchronize(self):
        self.event.synchronize()

    def elapsed_time(self, end_event) -> float:
        return self.event.elapsed_time(end_event.event)


def current_stream(device=None) -> Stream:
    return Stream(stream=torch.cuda.current_stream(_cuda(device)))


def set_stream(stream=None) -> Stream:
    """Make `stream` current on its device; returns the stream that was."""
    prev = current_stream(stream.device if stream is not None else None)
    if stream is not None:
        torch.cuda.set_stream(stream.stream)
    return prev


@contextlib.contextmanager
def stream_guard(stream):
    """Queue the block's work on `stream` (None: the current one)."""
    if stream is None:
        yield
        return
    with torch.cuda.stream(stream.stream):
        yield


def synchronize(device=None):
    """Wait for the work queued on the device; nothing to wait for on the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class cuda:
    """paddle.device.cuda: the device count, and the caching allocator's
    memory counters in bytes."""

    Stream = Stream
    Event = Event
    current_stream = staticmethod(current_stream)
    stream_guard = staticmethod(stream_guard)

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def is_available():
        return torch.cuda.is_available()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    @staticmethod
    def memory_allocated(device=None) -> int:
        return torch.cuda.memory_allocated(_cuda(device))

    @staticmethod
    def max_memory_allocated(device=None) -> int:
        return torch.cuda.max_memory_allocated(_cuda(device))

    @staticmethod
    def memory_reserved(device=None) -> int:
        return torch.cuda.memory_reserved(_cuda(device))

    @staticmethod
    def max_memory_reserved(device=None) -> int:
        return torch.cuda.max_memory_reserved(_cuda(device))

    @staticmethod
    def reset_max_memory_allocated(device=None):
        torch.cuda.reset_peak_memory_stats(_cuda(device))


class IPUPlace:
    def __init__(self, *a):
        raise NotImplementedError("IPU is not a target of this build")


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def is_compiled_with_custom_device(device_type=None):
    return False


def get_cudnn_version():
    """cuDNN's version as an int (90100 for 9.1.0), None without it."""
    if not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []
