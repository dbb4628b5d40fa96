"""The port's hapi (Model, callbacks, summary, flops), io_file and
parallel.functional.make_loss_fn against the JAX package's.

- LeNet on the synthetic MNIST, the reference's weights copied across
  (convert.load_reference_state), through `fit` (Adam at 1e-3,
  CrossEntropyLoss, Accuracy top-1 and top-2, 4 batches of 16 in a
  seeded shuffle), `evaluate` and `predict` in both packages in float32:
  each step's loss within LOSS_RTOL, the metrics within one sample of
  each other, the predictions within PRED_TOL. LOSS_RTOL and PRED_TOL are
  a few float32 roundings after four Adam steps (the same convolutions
  summed in other orders).
- `amp_configs="O1"` trains (bf16 convolutions and linears, float32
  master weights and gradients, a GradScaler whose update runs twice a
  step, as the reference's `train_batch` calls it after `step`): four
  steps on one fixed batch lower its loss.
- `.pdparams`/`.pdopt` written by the reference's `Model.save` load in
  the port's `Model.load`, and the port's in the reference's: the
  parameters and the optimizer's state bit for bit, and the next step's
  loss within LOSS_RTOL. bfloat16 tensors round-trip through the port's
  own files.
- EarlyStopping, LRScheduler and ModelCheckpoint do in the port what
  they do in the reference.
- `summary` gives the reference's counts; `flops` counts by the port's
  pricer (pir/analysis.price), where the reference reads XLA's cost
  analysis: on LeNet they part by FLOPS_RTOL (0.35%: XLA prices the
  ReLUs, pools and adds by its own rules, the convolutions and products
  alike).
- make_loss_fn: the same loss as the reference's on the same parameters
  and batch, and functional_call's rng_key fixes dropout's draw.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.flops import flops as jflops
from paddle_tpu.io import Subset as JSubset
from paddle_tpu.parallel.functional import make_loss_fn as jmake_loss_fn
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.io import Subset as PSubset
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.parallel.functional import functional_call, \
    make_loss_fn
from paddle_tpu_torch.vision.datasets import MNIST as PMNIST
from paddle_tpu_torch.vision.models import LeNet as PLeNet

LOSS_RTOL = 1e-4
PRED_TOL = 1e-4
FLOPS_RTOL = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    # the reference draws LeNet from its global key: seeded here, so the
    # weights do not depend on which tests ran before in the process
    paddle.seed(0)
    ref = JLeNet()
    port = PLeNet(device="cpu")
    load_reference_state(port, _np_state(ref))
    return ref, port


def _np_state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _recorder(base):
    class Losses(base):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    return Losses()


def _models():
    ref, port = _pair()
    jm = paddle.Model(ref)
    jm.prepare(jopt.Adam(1e-3, parameters=jm.parameters()),
               jnn.CrossEntropyLoss(), jmetric.Accuracy(topk=(1, 2)))
    pm = pt.Model(port)
    pm.prepare(popt.Adam(1e-3, parameters=pm.parameters()),
               pnn.CrossEntropyLoss(), pmetric.Accuracy(topk=(1, 2)))
    return jm, pm


def _fit(model, data, cb, **kw):
    np.random.seed(5)
    model.fit(data, batch_size=16, epochs=1, num_iters=4, verbose=0,
              callbacks=[cb], **kw)
    return cb.losses


def test_lenet_fit_evaluate_predict_match_reference():
    jm, pm = _models()
    jl = _fit(jm, JSubset(JMNIST(mode="train"), range(96)),
              _recorder(jcb.Callback))
    pl = _fit(pm, PSubset(PMNIST(mode="train"), range(96)),
              _recorder(pcb.Callback), num_workers=2)
    assert len(pl) == len(jl) == 4
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    test_j, test_p = JSubset(JMNIST(mode="test"), range(64)), \
        PSubset(PMNIST(mode="test"), range(64))
    want = jm.evaluate(test_j, batch_size=32, verbose=0)
    got = pm.evaluate(test_p, batch_size=32, verbose=0)
    assert set(got) == set(want) == {"loss", "acc_top1", "acc_top2"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for k in ("acc_top1", "acc_top2"):
        assert abs(got[k] - want[k]) <= 1 / 64, k
    jp = jm.predict(test_j, batch_size=32, stack_outputs=True)[0]
    tp = pm.predict(test_p, batch_size=32, stack_outputs=True)[0]
    assert tp.shape == (64, 10)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp._data),
                               rtol=PRED_TOL, atol=PRED_TOL)
    per_batch = pm.predict(test_p, batch_size=32)[0]
    assert len(per_batch) == 2


def test_amp_o1_trains():
    _, port = _pair()
    m = pt.Model(port)
    m.prepare(popt.Adam(1e-3, parameters=m.parameters()),
              pnn.CrossEntropyLoss(), pmetric.Accuracy(),
              amp_configs="O1")
    # four steps on one fixed batch of 16, so the loss falls whatever the
    # initialisation
    rec = _recorder(pcb.Callback)
    m.fit(PSubset(PMNIST(mode="train"), range(16)), batch_size=16,
          epochs=4, verbose=0, callbacks=[rec])
    losses = rec.losses
    assert len(losses) == 4
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert m._scaler._scale == 2.0 ** 16 and m._scaler._good_steps == 8
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with pytest.raises(ValueError):
        m.prepare(amp_configs="O3")
    m.prepare(popt.SGD(0.1, parameters=m.parameters()), pnn.MSELoss(),
              amp_configs={"level": "O0"})
    assert m._scaler is None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_load_across_packages(writer, tmp_path):
    jm, pm = _models()
    _fit(jm, JSubset(JMNIST(mode="train"), range(64)),
         _recorder(jcb.Callback))
    _fit(pm, PSubset(PMNIST(mode="train"), range(64)),
         _recorder(pcb.Callback))
    path = str(tmp_path / "ck")
    fresh_j, fresh_p = _models()
    if writer == "reference":
        jm.save(path)
        fresh_p.load(path)
        src = {k: np.asarray(v._data) for k, v in
               jm.network.state_dict().items()}
        dst = {k: v.numpy() for k, v in fresh_p.network.state_dict().items()}
        src_opt = {k: np.asarray(v._data) for k, v in
                   jm._optimizer.state_dict().items() if k[0].isdigit()}
        dst_opt = {k: v.numpy() for k, v in
                   fresh_p._optimizer.state_dict().items()
                   if k[0].isdigit()}
        step = fresh_p._optimizer._step_count
    else:
        pm.save(path)
        fresh_j.load(path)
        src = {k: v.numpy() for k, v in pm.network.state_dict().items()}
        dst = {k: np.asarray(v._data) for k, v in
               fresh_j.network.state_dict().items()}
        src_opt = {k: v.numpy() for k, v in
                   pm._optimizer.state_dict().items() if k[0].isdigit()}
        dst_opt = {k: np.asarray(v._data) for k, v in
                   fresh_j._optimizer.state_dict().items()
                   if k[0].isdigit()}
        step = fresh_j._optimizer._step_count
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    assert step == 4 and set(src) == set(dst) and set(src_opt) == \
        set(dst_opt) and len(src_opt) == 20
    for k in src:
        np.testing.assert_array_equal(dst[k], src[k])
    for k in src_opt:
        np.testing.assert_array_equal(dst_opt[k], src_opt[k])
    # the next step from the loaded state agrees with the writer's
    x = np.stack([PMNIST(mode="test")[i][0] for i in range(8)])
    y = np.array([PMNIST(mode="test")[i][1] for i in range(8)])
    loaded, writer_m = (fresh_p, jm) if writer == "reference" else \
        (fresh_j, pm)
    a = loaded.train_batch(x, y)[0]
    b = writer_m.train_batch(x, y)[0]
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)


def test_save_load_round_trips_bf16_and_nesting(tmp_path):
    obj = {"w": torch.randn(3, 2).bfloat16(), "n": 3,
           "seq": [torch.arange(4), (torch.ones(2), "s")]}
    pt.save(obj, str(tmp_path / "a" / "x.pdparams"))
    back = pt.load(str(tmp_path / "a" / "x.pdparams"))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], obj["w"]) and back["n"] == 3
    assert torch.equal(back["seq"][0], obj["seq"][0])
    assert isinstance(back["seq"][1], tuple) and back["seq"][1][1] == "s"
    ref = paddle.load(str(tmp_path / "a" / "x.pdparams"))
    np.testing.assert_array_equal(np.asarray(ref["w"]._data),
                                  obj["w"].float().numpy())
    paddle.save({"b": paddle.to_tensor(np.ones(3, np.float32)).astype(
        "bfloat16")}, str(tmp_path / "b.pdparams"))
    b = pt.load(str(tmp_path / "b.pdparams"))["b"]
    assert b.dtype == torch.bfloat16 and torch.equal(b, torch.ones(3).bfloat16())


def test_callbacks_do_what_the_reference_does(tmp_path):
    for cb, opt, lr, model_cls, net, data in (
            (jcb, jopt, jopt.lr, paddle.Model, JLeNet(),
             JSubset(JMNIST(mode="train"), range(64))),
            (pcb, popt, popt.lr, pt.Model, PLeNet(device="cpu"),
             PSubset(PMNIST(mode="train"), range(64)))):
        m = model_cls(net)
        sched = lr.StepDecay(0.01, step_size=1, gamma=0.5)
        m.prepare(opt.SGD(sched, parameters=m.parameters()),
                  (jnn if cb is jcb else pnn).CrossEntropyLoss())
        save_dir = str(tmp_path / cb.__name__.split(".")[0])
        stop = cb.EarlyStopping(monitor="loss", patience=1)
        m.fit(data, batch_size=16, epochs=2, verbose=0, shuffle=False,
              callbacks=[cb.LRScheduler(), stop,
                         cb.ModelCheckpoint(save_dir=save_dir)])
        assert sched.last_epoch == 8       # stepped once a batch
        for name in ("0", "1", "final"):
            assert os.path.exists(os.path.join(save_dir,
                                               name + ".pdparams"))
        stop.on_eval_end({"loss": [1.0]})
        stop.on_eval_end({"loss": [1.5]})
        assert m.stop_training
        log = cb.ProgBarLogger(log_freq=1, verbose=0)
        log.set_params({"epochs": 1})
        log.on_epoch_begin(0)
        log.on_train_batch_end(0, {"loss": 1.0})


def test_summary_and_flops():
    ref, port = _pair()
    want = paddle.summary(ref)
    assert pt.summary(port) == want == {"total_params": 61610,
                                        "trainable_params": 61610}
    assert pt.Model(port).summary() == want
    got, ref_flops = pt.flops(port, [1, 1, 28, 28]), jflops(ref,
                                                            [1, 1, 28, 28])
    assert abs(got - ref_flops) <= FLOPS_RTOL * ref_flops, (got, ref_flops)
    assert port.training                       # the mode restored
    lin = pnn.Linear(8, 4, device="cpu")
    assert pt.flops(lin, [[2, 8]]) == 2 * 2 * 8 * 4 + 2 * 4


def test_make_loss_fn_matches_reference():
    ref, port = _pair()
    rng = np.random.RandomState(1)
    x = rng.rand(4, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (4,))
    jfn = jmake_loss_fn(ref, jnn.functional.cross_entropy)
    want = float(jfn(_np_state(ref), (jnp.asarray(x), jnp.asarray(y)),
                     jax.random.PRNGKey(0)))
    pfn = make_loss_fn(port, PF.cross_entropy)
    params = dict(port.named_parameters())
    got = pfn(params, (torch.tensor(x), torch.tensor(y)), 0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    grads = torch.func.grad(pfn)(params, (torch.tensor(x),
                                          torch.tensor(y)), 0)
    assert set(grads) == set(params)


def test_functional_call_rng_key_fixes_dropout():
    drop = pnn.Dropout(0.5)
    x = torch.ones(64)
    a = functional_call(drop, {}, x, rng_key=7)
    b = functional_call(drop, {}, x, rng_key=7)
    c = functional_call(drop, {}, x, rng_key=8)
    g = torch.Generator().manual_seed(7)
    d = functional_call(drop, {}, x, rng_key=g)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, d)
    # the port's own stream goes on as if the keyed call had not been
    pt.seed(0)
    e1, e2 = functional_call(drop, {}, x), functional_call(drop, {}, x)
    pt.seed(0)
    f1 = functional_call(drop, {}, x)
    functional_call(drop, {}, x, rng_key=7)
    f2 = functional_call(drop, {}, x)
    assert torch.equal(e1, f1) and torch.equal(e2, f2)
