"""The port's training step against the JAX package's: the LM losses,
the stacked-parameter Llama (models.scanned) with its gradients under every
remat policy, AdamW, and the training tool.

Everything runs on the CPU, where attention takes the plain versions of the
flash kernels; the JAX side runs as its own tests run it (tests/
test_models.py). Weights are carried across with paddle_tpu_torch.convert;
other inputs are made with numpy from a seed and handed to both.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.models.scanned import build_scanned_llama as jax_scanned
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel import functional as JPF
import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.convert import load_reference_state, \
    tree_from_reference
from paddle_tpu_torch.models import LlamaConfig, build_scanned_llama
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import functional as PPF
from paddle_tpu_torch.tools import train_llama

# fp32 on both sides: the same math summed in other orders
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4

REMATS = [(False, None), (True, None), (True, "dots"), (True, "nothing")]


def _np_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _pair(seed=0, **kw):
    paddle.seed(seed)
    ref = paddle.models.llama_tiny(**kw)
    port = pt.models.llama_tiny(device="cpu", **kw)
    load_reference_state(port, _np_state(ref))
    return ref, port


def _ids(seed=0, shape=(2, 16)):
    return np.random.RandomState(seed).randint(0, 512, shape)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_scanned_loss_and_grads(tied):
    """The reference's scanned loss and grads (tests/test_models.py:208-247):
    remat does not change them, so one run serves every policy."""
    ref, _ = _pair(num_hidden_layers=3, tie_word_embeddings=tied)
    params, loss_fn = jax_scanned(ref, remat=False)
    ids = jnp.asarray(_ids(), jnp.int32)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, ids, ids)
    el, _ = ref(paddle.Tensor(ids), labels=paddle.Tensor(ids))
    return (float(loss), _numpy_tree(grads), _numpy_tree(params),
            float(el._data))


@pytest.mark.parametrize("remat,policy", REMATS,
                         ids=["off", "full", "dots", "nothing"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_scanned_loss_and_grads_match_reference(tied, remat, policy):
    want_loss, want_grads, _, imperative = _jax_scanned_loss_and_grads(tied)
    _, port = _pair(num_hidden_layers=3, tie_word_embeddings=tied)
    params, loss_fn = build_scanned_llama(port, remat=remat,
                                          remat_policy=policy)
    ids = torch.as_tensor(_ids())
    loss = loss_fn(params, ids, ids)
    loss.backward()
    assert loss_fn.lm_loss_path == "fused"
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(loss.item() - imperative) <= LOSS_RTOL * abs(imperative)
    assert ("lm_head" in params["head"]) == (not tied)
    assert {k: set(v) for k, v in params.items()} == \
        {k: set(v) for k, v in want_grads.items()}
    for group, leaves in want_grads.items():
        for name, want in leaves.items():
            got = params[group][name].grad
            assert got.shape == want.shape, (group, name)
            np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)


def test_scanned_params_tree_carries_across():
    """convert.tree_from_reference of the reference's params tree equals
    the port's own tree, leaf for leaf."""
    _, _, want, _ = _jax_scanned_loss_and_grads(False)
    _, port = _pair(num_hidden_layers=3)
    params, _ = build_scanned_llama(port)
    got = tree_from_reference(want, "cpu")
    for group, leaves in params.items():
        assert set(leaves) == set(got[group])
        for name, t in leaves.items():
            assert torch.equal(t.detach(), got[group][name]), name
    # dtype= casts every leaf, as the reference's does
    params16, _ = build_scanned_llama(port, dtype="bfloat16")
    for group, leaves in params16.items():
        for name, t in leaves.items():
            assert t.dtype == torch.bfloat16 and t.requires_grad
            assert torch.equal(t.detach(), params[group][name].detach().to(
                torch.bfloat16)), name


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="bogus"):
        build_scanned_llama(pt.models.llama_tiny(device="cpu"), remat=True,
                            remat_policy="bogus")


@pytest.mark.parametrize("tied", [False, True])
def test_causal_lm_labels_loss_matches_reference(tied):
    ref, port = _pair(tie_word_embeddings=tied)
    ids = _ids(1, (2, 11))
    want, want_logits = ref(paddle.Tensor(jnp.asarray(ids, jnp.int32)),
                            labels=paddle.Tensor(jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        loss, logits = port(torch.as_tensor(ids),
                            labels=torch.as_tensor(ids))
    assert logits.shape == (2, 11, 512) and loss.dim() == 0
    assert abs(loss.item() - float(want._data)) <= \
        LOSS_RTOL * abs(float(want._data))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits._data),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_matches_reference(reduction, ignore):
    rs = np.random.RandomState(4)
    logits = rs.randn(3, 7, 11).astype(np.float32)
    labels = rs.randint(0, 11, (3, 7))
    if ignore:
        labels[0, :3] = -100
    want = JF.cross_entropy(paddle.Tensor(jnp.asarray(logits)),
                            paddle.Tensor(jnp.asarray(labels, jnp.int32)),
                            reduction=reduction)
    got = PF.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                           reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)
    # labels with a trailing class axis of size 1 give the same result
    got1 = PF.cross_entropy(torch.as_tensor(logits),
                            torch.as_tensor(labels[..., None]),
                            reduction=reduction)
    assert torch.equal(got, got1)


def test_cross_entropy_refuses_what_is_not_ported():
    """Soft labels and label smoothing, which raised until they were
    ported, now give the reference's values (tests/test_torch_losses.py
    holds every form)."""
    x = torch.randn(2, 5)
    for label, kw in ((torch.softmax(x, -1), dict(soft_label=True)),
                      (torch.tensor([1, 2]), dict(label_smoothing=0.1))):
        want = JF.cross_entropy(paddle.to_tensor(x.numpy()),
                                paddle.to_tensor(label.numpy()), **kw)
        np.testing.assert_allclose(PF.cross_entropy(x, label, **kw).numpy(),
                                   np.asarray(want._data), rtol=1e-5)


def test_chunked_loss_matches_fused_and_reference():
    """rmsnorm_lm_loss_chunked over a ragged last chunk (19 positions in
    chunks of 8) against the fused loss, value and gradients, and against
    the reference's chunked loss."""
    rs = np.random.RandomState(6)
    h = rs.randn(2, 20, 32).astype(np.float32)
    w = (rs.randn(32, 50) * 0.2).astype(np.float32)
    norm = rs.rand(32).astype(np.float32) + 0.5
    labels = rs.randint(0, 50, (2, 20))
    want = float(JPF.rmsnorm_lm_loss_chunked(
        jnp.asarray(norm), jnp.asarray(w), jnp.asarray(h),
        jnp.asarray(labels, jnp.int32), 1e-6, chunk=8))
    grads = []
    for fn in (lambda *a: PPF.rmsnorm_lm_loss_chunked(*a, chunk=8),
               PPF.rmsnorm_lm_loss):
        ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(
            w, requires_grad=True)
        loss = fn(torch.as_tensor(norm), wt, ht, torch.as_tensor(labels),
                  1e-6)
        loss.backward()
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
        grads.append((ht.grad, wt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _random_opt_tree(rs):
    shapes = {"embed": {"weight": (6, 4)},
              "layers": {"w": (2, 4, 3), "norm": (2, 4)}}
    params, grads, states = {}, {}, {}
    for group, leaves in shapes.items():
        params[group], grads[group], states[group] = {}, {}, {}
        for name, shape in leaves.items():
            params[group][name] = rs.randn(*shape).astype(np.float32)
            grads[group][name] = (rs.randn(*shape) * 0.1).astype(np.float32)
            states[group][name] = {
                "moment1": (rs.randn(*shape) * 0.01).astype(np.float32),
                "moment2": (rs.rand(*shape) * 1e-3).astype(np.float32)}
    return params, grads, states


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_tree_update_matches_reference(dtype):
    """One AdamW step over a params tree, param by param and moment by
    moment, against the reference's compiled tree_update (traced step, so
    `beta ** step` and the update run in float32 while bf16 moments and
    params stay bf16). float32 agrees to rounding; bf16 moments bit for
    bit, and params to one bf16 step (2^-7 relative), since the port's bias
    corrections are taken in float64 before they meet the float32
    update."""
    rs = np.random.RandomState(3)
    params, grads, states = _random_opt_tree(rs)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jtree(t):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), t)
    jopt = joptim.AdamW(1e-3, parameters=[])
    want_p, want_s = jax.jit(jopt.tree_update)(
        jtree(params), jtree(grads), jtree(states), jnp.float32(1e-3),
        jnp.int32(3))
    opt = optimizer.AdamW(1e-3, parameters=[])
    got_p, got_s = opt.tree_update(
        *(tree_from_reference(t, "cpu", dtype) for t in
          (params, grads, states)), 1e-3, 3)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-6)
    for group in params:
        for name in params[group]:
            got = [got_p[group][name]] + [got_s[group][name][k]
                                          for k in ("moment1", "moment2")]
            want = [want_p[group][name]] + [want_s[group][name][k]
                                            for k in ("moment1", "moment2")]
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == pt.framework.convert_dtype(dtype)
                w = np.asarray(w.astype(jnp.float32))
                np.testing.assert_allclose(g.float().numpy(), w,
                                           err_msg=name, **tol)
                if dtype == "bfloat16" and i:   # the moments
                    np.testing.assert_array_equal(g.float().numpy(), w)


def test_three_tree_steps_lower_the_loss():
    """Mirror of tests/test_models.py:259-282 (trains with tree_update)."""
    _, port = _pair(num_hidden_layers=2)
    params, loss_fn = build_scanned_llama(port, remat=True)
    opt = optimizer.AdamW(1e-3, parameters=port.parameters())
    state = opt.tree_init(params)
    ids = torch.as_tensor(_ids())
    losses = []
    for i in range(3):
        loss = loss_fn(params, ids, ids)
        loss.backward()
        grads = {k: {n: t.grad for n, t in g.items()}
                 for k, g in params.items()}
        opt.tree_update(params, grads, state, 1e-3, i + 1)
        for g in params.values():
            for t in g.values():
                t.grad = None
        losses.append(loss.item())
    assert losses[-1] < losses[0]


def test_imperative_backward_trains_like_reference():
    """Mirror of tests/test_models.py:22: loss.backward(); opt.step();
    opt.clear_grad() for 5 steps, from the same weights, step by step
    against the reference (f32; Adam's sign-like first steps amplify the
    frameworks' rounding differences only where a gradient is near 0)."""
    ref, port = _pair()
    x = _ids(2)
    jopt = joptim.AdamW(1e-3, parameters=ref.parameters())
    opt = optimizer.AdamW(1e-3, parameters=port.parameters())
    xt = torch.as_tensor(x)
    xj = paddle.Tensor(jnp.asarray(x, jnp.int32))
    losses, want = [], []
    for _ in range(5):
        loss, _ = port(xt, labels=xt)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        jl, _ = ref(xj, labels=xj)
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(jl._data))
    assert losses[-1] < losses[0]
    assert all(p.grad is None for p in port.parameters())
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_optimizer_state_dict_round_trip_and_scheduler():
    model = torch.nn.Linear(3, 2)
    sched = optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = optimizer.Adam(sched, parameters=model.parameters())
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    sched.step()
    assert opt.get_lr() == pytest.approx(0.05)
    sd = opt.state_dict()
    assert sd["@step"] == 1 and {"0_moment1", "1_moment2"} <= set(sd)
    sched2 = optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt2 = optimizer.Adam(sched2, parameters=model.parameters())
    opt2.set_state_dict(sd)
    assert opt2._step_count == 1 and sched2.last_epoch == sched.last_epoch
    for p in model.parameters():
        for k, v in opt._accumulators[id(p)].items():
            assert torch.equal(opt2._accumulators[id(p)][k], v)


def test_lr_schedulers_match_reference():
    """The port's copy of optimizer/lr.py gives the reference's values."""
    def seq(mod):
        s = mod.LinearWarmup(mod.CosineAnnealingDecay(0.1, T_max=6), 3, 0.0,
                             0.1)
        out = []
        for _ in range(10):
            out.append(s())
            s.step()
        return out
    assert seq(optimizer.lr) == seq(joptim.lr)


def test_functional_call_honours_training_false():
    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(2, 2)
            self.inner = torch.nn.Dropout()
            self.seen = None

        def forward(self, x):
            self.seen = (self.training, self.inner.training)
            return self.lin(x)

    m = Probe()
    m.inner.eval()      # a submodule the caller keeps in eval
    w = torch.zeros(2, 2, requires_grad=True)
    out = PPF.functional_call(m, {"lin.weight": w}, torch.ones(1, 2),
                              training=False)
    assert m.seen == (False, False)
    assert m.training and not m.inner.training   # flags restored
    out.sum().backward()
    assert w.grad is not None and m.lin.weight.grad is None
    PPF.functional_call(m, {}, torch.ones(1, 2))
    assert m.seen == (True, False)


def test_run_one_trains_on_the_cpu():
    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2)
    before = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
              fa.flash_bwd_dkv_launches)
    r = train_llama.run_one(cfg, 2, 64, 2, True, loss_chunk_mb=0,
                            device="cpu")
    assert r["lm_loss_path"] == "chunked" and len(r["losses"]) == 3
    assert r["loss"] == r["losses"][-1] < r["losses"][0]
    assert np.isfinite(r["losses"]).all() and r["tokens_per_s"] > 0
    assert r["mfu"] is None and r["peak_memory_bytes"] is None
    assert r["n_params"] == pt.models.llama_tiny(
        device="cpu", num_attention_heads=2,
        num_key_value_heads=2).num_params()
    # the CPU takes the plain versions: no kernel launches
    assert r["launches_per_step"] == [{"flash_fwd": 0, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0}] * 2
    assert (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches) == before


def test_ladder_matches_bench():
    import bench
    got = train_llama.llama_ladder()
    want = bench._llama_ladder()
    assert [(n, b, s, st, r) for n, _, b, s, st, r in got] == \
        [(n, b, s, st, r) for n, _, b, s, st, r in want]
    for (_, c, *_), (_, jc, *_) in zip(got, want):
        assert c.__dict__ == {k: getattr(jc, k) for k in c.__dict__}
    assert all(train_llama.loss_chunk_mb_for(n) == bench._loss_chunk_mb_for(n)
               for n, *_ in got)
