"""The framework plumbing of the port against the JAX package's, on the
CPU: utils (unique_name, the decorators, run_check, cpp_extension on one
C source built by both packages), hub from a local hubconf.py, onnx's
raise, sysconfig, version, profiler.export_protobuf's record,
jit.set_code_level/set_verbosity, and the loadgen dashboard against the
reference renderer (tools/dashboard.py) on the same report."""

import contextlib
import importlib.util
import io
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


# -- utils.unique_name ---------------------------------------------------------

def test_unique_name_sequences_equal_reference():
    keys = ["fc", "fc", "conv", "fc", "static_fc", "conv"]
    with paddle.utils.unique_name.guard():
        want = [paddle.utils.unique_name.generate(k) for k in keys]
    with pt.utils.unique_name.guard():
        got = [pt.utils.unique_name.generate(k) for k in keys]
    assert got == want == ["fc_0", "fc_1", "conv_0", "fc_2", "static_fc_0",
                           "conv_1"]


def test_unique_name_guard_and_switch_restore():
    un = pt.utils.unique_name
    with un.guard():
        un.generate("k")
        with un.guard():
            assert un.generate("k") == "k_0"
        assert un.generate("k") == "k_1"
        old = un.switch()
        assert un.generate("k") == "k_0"
        un.switch(old)
        assert un.generate("k") == "k_2"


# -- utils -------------------------------------------------------------------

def test_deprecated_try_import_require_version():
    for mod in (paddle.utils, pt.utils):
        @mod.deprecated(update_to="new_fn", since="0.1", reason="r")
        def old_fn(x):
            return x + 1
        with pytest.warns(DeprecationWarning, match="use new_fn instead"):
            assert old_fn(1) == 2

        @mod.deprecated(level=2)
        def gone():
            pass
        with pytest.raises(RuntimeError, match="is deprecated"):
            gone()
        assert mod.try_import("json") is json
        with pytest.raises(ImportError, match="no_such_module"):
            mod.try_import("no_such_module_xyz")
        mod.require_version("0.0.1")
        with pytest.raises(Exception, match="required"):
            mod.require_version("99.0")
        with pytest.raises(Exception, match="maximum"):
            mod.require_version("0.0.1", "0.0.2")


def test_run_check_on_the_default_device():
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pt.utils.run_check()
    finally:
        pt.set_device(old)
    # 128 x 128 ones squared: the reference's checksum
    assert "works on cpu" in buf.getvalue()
    assert "matmul checksum 2097152" in buf.getvalue()


# -- utils.cpp_extension -----------------------------------------------------

C_SOURCE = r"""
#include <cstdint>
extern "C" void axpy(const void** in, void** out,
                     const int64_t* const* shapes, const int* ndims, int n) {
  const float* x = static_cast<const float*>(in[0]);
  const float* y = static_cast<const float*>(in[1]);
  float* o = static_cast<float*>(out[0]);
  int64_t m = 1;
  for (int d = 0; d < ndims[0]; ++d) m *= shapes[0][d];
  for (int64_t i = 0; i < m; ++i) o[i] = 3.0f * x[i] + y[i];
}
extern "C" void row_sums(const void** in, void** out,
                         const int64_t* const* shapes, const int* ndims,
                         int n) {
  const float* x = static_cast<const float*>(in[0]);
  float* s = static_cast<float*>(out[0]);
  int32_t* c = static_cast<int32_t*>(out[1]);
  for (int64_t r = 0; r < shapes[0][0]; ++r) {
    s[r] = 0;
    for (int64_t j = 0; j < shapes[0][1]; ++j)
      s[r] += x[r * shapes[0][1] + j];
    c[r] = static_cast<int32_t>(shapes[0][1]);
  }
}
"""


@pytest.fixture(scope="module")
def c_source(tmp_path_factory):
    d = tmp_path_factory.mktemp("cpp_ext")
    src = d / "ops.cc"
    src.write_text(C_SOURCE)
    return d, str(src)


def test_cpp_extension_one_source_in_both_packages(c_source, monkeypatch):
    d, src = c_source
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(d / "build"))
    ref = paddle.utils.cpp_extension.load("ops", [src])
    port = pt.utils.cpp_extension.load("ops", [src])
    assert port._path == ref._path      # the same build, cached by hash
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = np.full((2, 3), 0.25, np.float32)
    want = ref.op("axpy")(paddle.to_tensor(x), paddle.to_tensor(y))
    got = port.op("axpy")(torch.tensor(x), torch.tensor(y))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))

    def shapes(s):
        return [(s[0],), (s[0],)]

    def dtypes(dt):
        return [np.float32, np.int32]
    sums, counts = port.op("row_sums", shapes, dtypes)(torch.tensor(x))
    rsums, rcounts = ref.op("row_sums", shapes, dtypes)(paddle.to_tensor(x))
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(rsums._data))
    np.testing.assert_array_equal(counts.numpy(), [3, 3])


def test_cpp_extension_build_directory_flags_and_failures(c_source,
                                                          tmp_path,
                                                          monkeypatch):
    d, src = c_source
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path))
    a = pt.utils.cpp_extension.load("ops", [src],
                                    build_directory=str(tmp_path))
    b = pt.utils.cpp_extension.load("ops", [src], extra_cxx_cflags=["-O1"],
                                    build_directory=str(tmp_path))
    assert Path(a._path).parent == tmp_path and a._path != b._path
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="build of bad failed"):
        pt.utils.cpp_extension.load("bad", [str(bad)],
                                    build_directory=str(tmp_path))
    ext = pt.utils.cpp_extension.CUDAExtension([src])
    assert isinstance(ext, pt.utils.cpp_extension.CppExtension)
    lib = pt.utils.cpp_extension.setup(name="ops_setup", ext_modules=ext)
    assert isinstance(lib, pt.utils.cpp_extension.CustomOpLibrary)


def test_cpp_extension_build_directory_default(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_EXTENSION_DIR", raising=False)
    d = Path(pt.utils.cpp_extension.get_build_directory())
    assert d == ROOT / "paddle_tpu_torch" / "_build" / "extensions"
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path / "x"))
    assert pt.utils.cpp_extension.get_build_directory() == \
        str(tmp_path / "x")
    assert (tmp_path / "x").is_dir()


# -- hub -----------------------------------------------------------------------

HUBCONF = '''
def tiny(scale=1.0):
    """A tiny entry point."""
    return {"scale": scale}


def other():
    return "other"


def _private():
    pass
'''


@pytest.fixture
def hub_repo(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    return str(tmp_path)


def test_hub_local_as_the_reference(hub_repo):
    assert pt.hub.list(hub_repo) == paddle.hub.list(hub_repo) == \
        ["tiny", "other"]
    assert pt.hub.help(hub_repo, "tiny") == paddle.hub.help(hub_repo,
                                                             "tiny")
    assert pt.hub.load(hub_repo, "tiny", scale=2.0) == \
        paddle.hub.load(hub_repo, "tiny", scale=2.0) == {"scale": 2.0}


@pytest.mark.parametrize("mod", ["port", "ref"])
def test_hub_errors(hub_repo, tmp_path_factory, mod):
    hub = pt.hub if mod == "port" else paddle.hub
    with pytest.raises(RuntimeError, match="source 'github'"):
        hub.load(hub_repo, "tiny", source="github")
    with pytest.raises(ValueError, match="nope not found"):
        hub.load(hub_repo, "nope")
    with pytest.raises(FileNotFoundError, match="no hubconf.py"):
        hub.list(str(tmp_path_factory.mktemp("empty")))


# -- onnx, sysconfig, version ------------------------------------------------

def test_onnx_export_raises_as_the_reference():
    layer = pt.nn.Linear(2, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="jit.save"):
        pt.onnx.export(layer, "m")
    with pytest.raises(NotImplementedError):
        paddle.onnx.export(paddle.nn.Linear(2, 2), "m")


def test_sysconfig_points_at_the_ports_sources_and_builds():
    inc, lib = Path(pt.sysconfig.get_include()), Path(pt.sysconfig.get_lib())
    assert (inc / "tcp_store.cc").exists() and (inc / "collate.cc").exists()
    assert lib == ROOT / "paddle_tpu_torch" / "_build"
    assert Path(paddle.sysconfig.get_include()).name == "native"


def test_version_reports_the_torch_build():
    for name in ("full_version", "major", "minor", "patch", "rc", "commit",
                 "istaged", "with_pip_cuda_libraries"):
        assert getattr(pt.version, name) == getattr(paddle.version, name)
    assert pt.version.cuda() == (torch.version.cuda or "False")
    cudnn = torch.backends.cudnn.version() if torch.version.cuda else None
    assert pt.version.cudnn() == (str(cudnn) if cudnn else "False")
    assert pt.version.xpu() == paddle.version.xpu() == "False"
    assert isinstance(pt.version.nccl(), str)
    if not torch.cuda.is_available():
        assert pt.version.tpu() == "unavailable"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pt.version.show()
    lines = buf.getvalue().splitlines()
    assert lines[:2] == ["full_version: 0.1.0", "commit: unknown"]
    assert lines[2].startswith("accelerator: ")


# -- profiler.export_protobuf, jit's log levels -------------------------------

def _read_record(path):
    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert n == len(raw) - 8
    return pickle.loads(raw[8:])


def test_export_protobuf_record_as_the_reference(tmp_path):
    from paddle_tpu import profiler as jprof
    prof = pt.profiler.Profiler(targets=[pt.profiler.ProfilerTarget.CPU])
    with prof:
        a = torch.ones(16, 16)
        (a @ a).sum()
    path = pt.profiler.export_protobuf(prof, str(tmp_path / "p.pb"))
    events = _read_record(path)
    assert events == prof.events()
    names = {e["name"] for e in events}
    assert "aten::mm" in names
    assert {e["device"] for e in events} == {"cpu"}
    assert all(e["duration_us"] >= 0 for e in events)
    # the same events through the reference's writer: the same bytes
    jprof.export_protobuf(events, str(tmp_path / "r.pb"))
    pt.profiler.export_protobuf(events, str(tmp_path / "q.pb"))
    assert (tmp_path / "r.pb").read_bytes() == (tmp_path / "q.pb").read_bytes()
    for mod in (pt.profiler, jprof):
        with pytest.raises(ValueError, match="profiler result"):
            mod.export_protobuf(None, str(tmp_path / "x.pb"))


def test_jit_log_levels_as_the_reference():
    from paddle_tpu import jit as jjit
    for mod in (pt.jit, jjit):
        mod.set_code_level(3, also_to_stdout=True)
        mod.set_verbosity(2)
        assert (mod._code_level, mod._verbosity) == (3, 2)
        mod.set_code_level()
        mod.set_verbosity()
        assert (mod._code_level, mod._verbosity) == (100, 0)


# -- the loadgen dashboard -----------------------------------------------------

def _reference_dashboard():
    spec = importlib.util.spec_from_file_location(
        "reference_dashboard", ROOT / "tools" / "dashboard.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's loadgen CLI on the CPU with --dashboard: (rc, stderr, the
    report it wrote)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.profiler.phases import get_phase_accountant
    from paddle_tpu_torch.tools import loadgen as cli
    out = tmp_path_factory.mktemp("dash") / "report.json"
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--device", "cpu", "--scenario", "chat",
                           "--duration", "0.2", "--dashboard", "--out",
                           str(out)])
    finally:
        acct = get_phase_accountant()
        acct.disable()
        acct.reset()
        obs.disable()
        obs.get_registry().reset()
    return rc, err.getvalue(), json.loads(out.read_text())


def test_loadgen_cli_renders_the_dashboard(cli_run):
    rc, err, report = cli_run
    assert rc == 0, err
    board = err[err.index("== observability dashboard =="):]
    rows = [line.split()[0] for line in board.splitlines()[2:]
            if line.strip() and not line.startswith(("SLO", " "))]
    assert set(report["timeseries"]["rules"]) <= set(rows)
    assert "SLO verdict:" in board


def test_dashboard_equals_reference_renderer(cli_run, tmp_path):
    from paddle_tpu_torch.tools import dashboard
    ref = _reference_dashboard()
    report = cli_run[2]
    assert dashboard.render(report) == ref.render(report)
    assert dashboard.build(report) == ref.build(report)
    tsdb = {"format": 1, "frozen": ["r1"], "series": [
        {"name": "rule/goodput_rate", "labels": {},
         "points": [[0, 1.0], [1, 3.0], [2, 2.0]]},
        {"name": "replica_load", "labels": {"replica": "r0"},
         "points": [[0, 0.5]]},
        {"name": "replica_load", "labels": {"replica": "r1"},
         "points": [[0, 0.25]]}]}
    assert dashboard.render(tsdb, report=report, width=8) == \
        ref.render(tsdb, report=report, width=8)
    assert dashboard.sparkline(range(10), 4) == ref.sparkline(range(10), 4)
    path = tmp_path / "r.json"
    path.write_text(json.dumps(report))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dashboard.main([str(path), "--json"]) == 0
    assert json.loads(buf.getvalue()) == json.loads(
        json.dumps(ref.build(report), default=str))
