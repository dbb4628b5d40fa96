"""Inference. reference: paddle_tpu/inference/__init__.py.

The continuous-batching serving engine over the paged KV pool
(`serving.py`) with its knobs: speculative decode (`drafting.py`), LoRA
adapters (`adapters.py`), the SLO scheduler (`scheduler.py`) and the
prefix cache (`prefix_cache.py`); the open-loop traffic harness
(`loadgen.py`); the disaggregated serving mesh (`mesh/`: replicas in
process or as child workers, the router, the KV hand-off); and the
predictor API over `jit.save` artifacts (`Config`, `Predictor`,
`create_predictor`, below).

The inference "program" is the `torch.export` program that `jit.save`
writes (the reference's is StableHLO). Config keeps the reference's knob
surface; Predictor keeps the zero-copy handle API
(get_input_handle/run/get_output_handle). The device is CUDA unless the
config asks for the CPU (`disable_gpu()`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .adapters import (AdapterLoadError, AdapterStore, LoraWeights,
                       demo_store_for_engine, make_demo_store,
                       per_adapter_slos)
from .loadgen import (SCENARIOS, Scenario, build_schedule, check_report,
                      run_scenario)
from .scheduler import BROWNOUT_LEVELS, PRIORITY_CLASSES, SLOScheduler
from .serving import (BackpressureError, ContinuousBatchingEngine,
                      KVPoolExhaustedError, Request)
from .mesh import KVHandoffError, MeshRouter, ReplicaPool

__all__ = ["ContinuousBatchingEngine", "Request", "BackpressureError",
           "KVPoolExhaustedError",
           "AdapterStore", "AdapterLoadError", "LoraWeights",
           "make_demo_store", "demo_store_for_engine", "per_adapter_slos",
           "Scenario", "SCENARIOS", "build_schedule", "run_scenario",
           "check_report",
           "SLOScheduler", "PRIORITY_CLASSES", "BROWNOUT_LEVELS",
           "MeshRouter", "ReplicaPool", "KVHandoffError",
           "Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "PlaceType", "get_version"]


def get_version():
    from .. import __version__
    return __version__


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM = 3


class Config:
    """reference: paddle/fluid/inference/api/paddle_analysis_config.h.
    Knobs that have no counterpart here (TensorRT, MKLDNN, ...) are
    accepted and recorded so reference code runs unchanged."""

    def __init__(self, prog_file=None, params_file=None):
        self._prefix = (prog_file[:-len(".pdmodel")]
                        if prog_file and prog_file.endswith(".pdmodel")
                        else prog_file)
        self._params_path = params_file
        self._precision = PrecisionType.Float32
        self._device = "cuda"
        self._enable_memory_optim = True
        self._flags = {}

    def set_model(self, prog_file, params_file=None):
        self._prefix = (prog_file[:-len(".pdmodel")]
                        if prog_file.endswith(".pdmodel") else prog_file)
        if params_file is not None:
            self._params_path = params_file

    def model_dir(self):
        return self._prefix

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=None):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device.startswith("cuda")

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag

    def enable_mkldnn(self):
        self._flags["mkldnn"] = True

    def enable_tensorrt_engine(self, **kwargs):
        self._flags["tensorrt"] = kwargs   # recorded; nothing to hand it to

    def switch_ir_optim(self, flag=True):
        self._flags["ir_optim"] = flag

    def switch_use_feed_fetch_ops(self, flag=False):
        pass

    def switch_specify_input_names(self, flag=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        self._flags["cpu_threads"] = n

    def enable_low_precision(self, precision=PrecisionType.Bfloat16):
        self._precision = precision

    def summary(self):
        return {"model": self._prefix, "device": self._device,
                "precision": self._precision, **self._flags}


class Tensor:
    """Zero-copy I/O handle. reference:
    paddle/fluid/inference/api/paddle_tensor.h ZeroCopyTensor."""

    def __init__(self, name, shape=None, dtype=np.float32):
        self._name = name
        self._value = None
        self._shape = shape
        self._dtype = dtype

    def name(self):
        return self._name

    def copy_from_cpu(self, data):
        self._value = np.ascontiguousarray(data)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def reshape(self, shape):
        self._shape = tuple(shape)

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._shape or [])

    def type(self):
        return self._dtype


def _host(t):
    """A program output as host numpy. numpy has no bfloat16 or float8,
    so those come back as float32, which holds them exactly."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()
    return t.cpu().numpy()


class Predictor:
    """reference: paddle/fluid/inference/api/paddle_inference_api.h
    Predictor over a jit.save artifact: the params are loaded onto the
    config's device once, and `run` moves its inputs there, runs the
    deserialized program and hands back host numpy."""

    def __init__(self, config: Config):
        from ..jit import load
        self._config = config
        self._layer = load(config._prefix, device=config._device,
                           params_path=config._params_path)
        if self._layer.program is None:
            raise ValueError(
                f"{config._prefix}.pdmodel holds no serialized program; "
                "re-export with paddle_tpu_torch.jit.save(layer, path, "
                "input_spec=[...])")
        self._input_spec = self._layer._input_spec
        self._input_names = [f"x{i}" for i in range(len(self._input_spec))]
        self._inputs = {n: Tensor(n, shape=tuple(s[0]), dtype=s[1])
                        for n, s in zip(self._input_names, self._input_spec)}
        self._outputs = []
        # enable_low_precision note: the exported program's calling
        # convention pins param and input dtypes, so casting after export
        # is invalid; the precision is recorded and nothing is cast (a
        # bf16 model is saved in bf16)

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def run(self, inputs=None):
        if inputs is not None:  # list-style API
            arrs = [np.asarray(getattr(x, "_value", x)) for x in inputs]
        else:
            arrs = [self._inputs[n]._value for n in self._input_names]
            if any(a is None for a in arrs):
                missing = [n for n in self._input_names
                           if self._inputs[n]._value is None]
                raise ValueError(f"inputs not set: {missing}")
        out = self._layer(*(np.ascontiguousarray(a) for a in arrs))
        self._outputs = []
        for i, o in enumerate(pytree.tree_leaves(out)):
            t = Tensor(f"out{i}")
            t._value = _host(o)
            self._outputs.append(t)
        if inputs is not None:
            return self._outputs
        return True

    def get_output_names(self):
        return [t.name() for t in self._outputs]

    def get_output_handle(self, name):
        for t in self._outputs:
            if t.name() == name:
                return t
        if not self._outputs:
            raise RuntimeError("no outputs yet — call run() first")
        raise KeyError(name)

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config) -> Predictor:
    """reference: paddle_infer::CreatePredictor."""
    return Predictor(config)
