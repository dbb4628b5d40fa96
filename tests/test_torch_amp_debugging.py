"""The port's amp.debugging against the JAX package's: check_numerics'
stats and values, the dumps and compare_accuracy, the tensor checker's
configuration, operator stats and check_layer_numerics, on the cases of
tests/test_misc_api.py::TestAmpDebugging and tests/test_longtail_misc.py.
The checker's raise on forward and backward ops is in
tests/test_torch_autograd.py."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch.amp import debugging as dbg

ARRAYS = {
    "nan": np.array([1.0, np.nan], np.float32),
    "clean": np.array([3.0, -1.0, 1.0], np.float32),
    "inf_zero": np.array([0.0, np.inf, -2.0, 0.0], np.float32),
    "empty": np.empty((0,), np.float32),
    "ints": np.array([0, 3, -2], np.int64),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_check_numerics_matches_reference(name):
    a = ARRAYS[name]
    mode = dict(debug_mode=dbg.DebugMode.CHECK_NAN_INF)
    stats, values = dbg.check_numerics(torch.as_tensor(a), "op", "x", **mode)
    want = jdbg.check_numerics(paddle.to_tensor(a), "op", "x",
                               debug_mode=jdbg.DebugMode.CHECK_NAN_INF)
    assert stats.dtype == torch.int64 and values.dtype == torch.float32
    assert stats.tolist() == np.asarray(want[0]._data).tolist()
    np.testing.assert_allclose(values.numpy(), np.asarray(want[1]._data),
                               rtol=1e-6)


def test_check_numerics_aborts_and_bfloat16():
    with pytest.raises(RuntimeError, match="NaN"):
        dbg.check_numerics(torch.tensor([1.0, float("nan")]), "op", "x")
    with pytest.raises(RuntimeError, match="NaN"):
        dbg.check_numerics(torch.tensor([1.0, float("nan")],
                                        dtype=torch.bfloat16), "op", "x")


def test_dump_and_compare_accuracy(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    for d, scale in ((d1, 1.0), (d2, 2.0)):
        dbg.check_numerics(torch.ones(4) * scale, "op", "v",
                           debug_mode=dbg.DebugMode.DUMP_ALL,
                           output_dir=str(d))
    dbg.check_numerics(torch.tensor([np.nan]), "op", "bad",
                       debug_mode=dbg.DebugMode.DUMP_FAIL, output_dir=str(d1))
    rows = dbg.compare_accuracy(str(d1), str(d2), str(tmp_path / "r.csv"))
    assert rows == [("op__bad.npy", "missing", "", ""),
                    ("op__v.npy", "ok", "1.000000e+00", "1.000000e+00")]
    assert (tmp_path / "r.csv").read_text().startswith(
        "tensor,status,max_abs_diff")


def test_tensor_checker_config():
    try:
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
        assert pt.get_flags(["FLAGS_check_nan_inf",
                             "FLAGS_check_nan_inf_level"]) == {
            "FLAGS_check_nan_inf": True, "FLAGS_check_nan_inf_level": 1}
        assert isinstance(_get_current_dispatch_mode(), dbg._NanInfChecker)
        with pytest.warns(RuntimeWarning, match="aten.div"):
            torch.tensor([1.0]) / torch.tensor([0.0])
    finally:
        dbg.disable_tensor_checker()
    assert _get_current_dispatch_mode() is None
    assert not pt.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=False))
    assert _get_current_dispatch_mode() is None
    for kw in (dict(debug_mode=dbg.DebugMode.DUMP_ALL),
               dict(checked_op_list=["matmul"]), dict(debug_step=[0, 1])):
        with pytest.raises(NotImplementedError):
            dbg.enable_tensor_checker(dbg.TensorCheckerConfig(True, **kw))


def test_checker_names_the_op_in_a_layer_and_skips_empty():
    lin = pt.nn.Linear(2, 2, device="cpu")
    with torch.no_grad():
        lin.weight.fill_(float("inf"))
    checked = dbg.check_layer_numerics(lin)
    with pytest.raises(RuntimeError, match="NaN or Inf"):
        checked(torch.ones(1, 2))
    assert _get_current_dispatch_mode() is None
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        torch.empty(1000)          # uninitialised memory is not scanned
        out = dbg.check_layer_numerics(pt.nn.Linear(2, 2, device="cpu"))(
            torch.ones(1, 2))
        assert list(out.shape) == [1, 2]
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})


def test_operator_stats(capsys):
    F = pt.nn.functional
    x, w = torch.ones(2, 3), torch.ones(3, 4)
    with dbg.collect_operator_stats():
        F.linear(x, w)
        with pt.amp.auto_cast():
            F.linear(x, w)
            F.softmax(x)
        dbg.enable_operator_stats_collection()      # nested: one count
        F.linear(x, w)
        assert dbg.disable_operator_stats_collection() == {
            ("linear", "float32"): 2, ("linear", "bfloat16"): 1,
            ("softmax", "float32"): 1}
    out = capsys.readouterr().out
    assert "calls" in out and "bfloat16" in out
    assert pt.amp._op_observer is None
    assert dbg.disable_operator_stats_collection() == {}
