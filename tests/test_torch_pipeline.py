"""The port's pipeline schedules (parallel/pipeline.py) and pipelined Llama
(parallel/llama_pipeline.py) against the JAX package's, the reference on
its virtual CPU devices, as tests/test_pipeline.py runs it: the toy LM's
fill-drain loss and gradients, 1F1B and the deferred-wgrad (ZB) schedule
with and without tied embeddings, the interleaved forward, and
LlamaPipeRunner under FThenB, 1F1B, ZB and VPP on a tiny Llama: the losses
and every parameter after two AdamW steps. Float32 on both sides;
tolerance 1e-5 on losses and gradients, 1e-4 relative / 1e-5 absolute on
parameters after AdamW (whose first steps move an element by about lr
whatever its gradient's size)."""

import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu import optimizer as ropt
from paddle_tpu.parallel import pipeline as rpipe
from paddle_tpu.parallel.llama_pipeline import LlamaPipeRunner as RRunner
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_reference_pipe, load_reference_state
from paddle_tpu_torch.parallel import pipeline as pipe
from paddle_tpu_torch.parallel.llama_pipeline import LlamaPipeRunner
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
V, DM = 64, 16


# -- the toy LM of tests/test_pipeline.py, in both packages ----------------

def _toy_weights(p, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(V, DM).astype(np.float32) * 0.1,
            rs.randn(p, DM, DM).astype(np.float32) * 0.1,
            rs.randn(DM, V).astype(np.float32) * 0.1)


def _tokens(m, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (2 * m, 8)).astype(np.int64),
            rs.randint(0, V, (2 * m, 8)).astype(np.int64))


def _jax_fns(tied):
    def embed_fn(p, tok):
        return p[tok]

    def stage_fn(p, h):
        return jnp.tanh(h @ p) + h

    if tied:
        def head_fn(hp, ep, h, lab):
            lp = jax.nn.log_softmax((h * hp[None, None]) @ ep.T, -1)
            return -jnp.mean(jnp.take_along_axis(lp, lab[..., None], -1))
    else:
        def head_fn(p, h, lab):
            lp = jax.nn.log_softmax(h @ p, -1)
            return -jnp.mean(jnp.take_along_axis(lp, lab[..., None], -1))
    return embed_fn, stage_fn, head_fn


def _torch_fns(tied):
    def embed_fn(p, tok):
        return p[tok]

    def stage_fn(p, h):
        return torch.tanh(h @ p) + h

    if tied:
        def head_fn(hp, ep, h, lab):
            lp = torch.log_softmax((h * hp[None, None]) @ ep.T, -1)
            return -lp.gather(-1, lab[..., None]).mean()
    else:
        def head_fn(p, h, lab):
            lp = torch.log_softmax(h @ p, -1)
            return -lp.gather(-1, lab[..., None]).mean()
    return embed_fn, stage_fn, head_fn


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_fill_drain_loss_and_grads_match_reference():
    p, m = 4, 4
    ew, sw, hw = _toy_weights(p)
    tok, lab = _tokens(m)
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("pp",))
    ref = rpipe.PipelinedLM(mesh, *_jax_fns(False), num_microbatches=m)
    rl, rg = jax.jit(jax.value_and_grad(ref.loss_fn(), argnums=(0, 1, 2)))(
        ew, sw, hw, jnp.asarray(tok), jnp.asarray(lab))
    pmesh = dist.ProcessMesh(shape=[p], dim_names=["pp"], device="cpu")
    plm = pipe.PipelinedLM(pmesh, *_torch_fns(False), num_microbatches=m)
    ws = [torch.from_numpy(w).requires_grad_() for w in (ew, sw, hw)]
    loss = plm.loss_fn()(*ws, torch.from_numpy(tok), torch.from_numpy(lab))
    loss.backward()
    _close(loss, rl)
    for w, g in zip(ws, rg):
        _close(w.grad, g)


@pytest.mark.parametrize("p,m,deferred,tied", [
    (4, 4, False, False), (2, 4, True, False), (4, 2, False, True),
    (2, 2, True, True)])
def test_1f1b_and_zb_grads_match_reference(p, m, deferred, tied):
    ew, sw, hw = _toy_weights(p)
    if tied:
        hw = np.ones(DM, np.float32)
    tok, lab = _tokens(m)
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("pp",))
    cls = rpipe.ZeroBubblePipeline if deferred else rpipe.OneFOneBPipeline
    ref = cls(mesh, *_jax_fns(tied), num_microbatches=m, tied_embed=tied)
    want = jax.jit(ref.loss_and_grad_fn())(ew, sw, hw, jnp.asarray(tok),
                                           jnp.asarray(lab))
    pmesh = dist.ProcessMesh(shape=[p], dim_names=["pp"], device="cpu")
    pcls = pipe.ZeroBubblePipeline if deferred else pipe.OneFOneBPipeline
    got = pcls(pmesh, *_torch_fns(tied), num_microbatches=m,
               tied_embed=tied).loss_and_grad_fn()(
        *(torch.from_numpy(w) for w in (ew, sw, hw)),
        torch.from_numpy(tok), torch.from_numpy(lab))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("v,m", [(2, 4), (3, 2)])
def test_interleaved_forward_matches_reference(v, m):
    p = 2
    rs = np.random.RandomState(0)
    cw = rs.randn(p, v, DM, DM).astype(np.float32) * 0.1
    x = rs.randn(m, 3, DM).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("pp",))
    stage_jax, stage_torch = _jax_fns(False)[1], _torch_fns(False)[1]

    def inner(cw_l, x_l):
        return rpipe.pipeline_forward_interleaved(
            stage_jax, cw_l, x_l, "pp", p_size=p, num_chunks=v,
            remat=False)[None]

    want = jax.jit(rpipe.shard_map(inner, mesh=mesh,
                                   in_specs=(JP("pp"), JP()),
                                   out_specs=JP("pp")))(cw, x)[-1]
    got = pipe.pipeline_forward_interleaved(
        stage_torch, torch.from_numpy(cw), torch.from_numpy(x), "pp",
        p_size=p, num_chunks=v, remat=False)
    _close(got, want)
    with pytest.raises(ValueError, match="microbatches"):
        pipe.pipeline_forward_interleaved(stage_torch, torch.from_numpy(cw),
                                          torch.zeros(3, 2, DM), p_size=p,
                                          num_chunks=v)


def _peak_live_inputs(run):
    """The most stage inputs alive at once while `run(embed_fn, stage_fn)`
    runs: every activation embed_fn or stage_fn makes without grad is
    tracked by a weak reference."""
    refs, peak = [], [0]

    def track(t):
        if not torch.is_grad_enabled():
            refs.append(weakref.ref(t))
            peak[0] = max(peak[0], sum(r() is not None for r in refs))
        return t

    embed_fn, stage_fn, head_fn = _torch_fns(False)
    run(lambda p, tok: track(embed_fn(p, tok)),
        lambda p, h: track(stage_fn(p, h)), head_fn)
    return peak[0]


def test_1f1b_buffer_keeps_the_o_p_bound():
    """At m >> p 1F1B keeps min(m, 2p - 1) inputs a stage (plus what is in
    flight), the deferred wgrad all m; the reference's
    test_peak_memory_beats_fill_drain_at_many_microbatches."""
    p, m = 2, 8
    ew, sw, hw = (torch.from_numpy(w) for w in _toy_weights(p))
    tok, lab = (torch.from_numpy(a) for a in _tokens(m))
    mesh = dist.ProcessMesh(shape=[p], dim_names=["pp"], device="cpu")

    def run_with(deferred):
        cls = pipe.ZeroBubblePipeline if deferred else pipe.OneFOneBPipeline
        return lambda e, s, h: cls(mesh, e, s, h, m).loss_and_grad_fn()(
            ew, sw, hw, tok, lab)

    one = _peak_live_inputs(run_with(False))
    zb = _peak_live_inputs(run_with(True))
    assert one <= p * (2 * p - 1) + p < p * m <= zb


# -- LlamaPipeRunner against the reference's ------------------------------

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_attention_heads=2, num_key_value_heads=2,
          max_position_embeddings=64)
RUNNER_CASES = [("FThenB", 2), ("1F1B", 2), ("ZB", 2), ("VPP", 4)]


def _runner_pair(schedule, layers, tied):
    paddle.seed(0)
    ref = paddle.models.llama_tiny(num_hidden_layers=layers,
                                   tie_word_embeddings=tied, **KW)
    np_state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    rr = RRunner(ref, mesh, num_microbatches=2, schedule=schedule,
                 optimizer=ropt.AdamW(1e-2, parameters=ref.parameters()))
    port = pt.models.llama_tiny(device="cpu", num_hidden_layers=layers,
                                tie_word_embeddings=tied, **KW)
    load_reference_state(port, np_state)
    pmesh = dist.ProcessMesh(shape=[2], dim_names=["pp"], device="cpu")
    pr = LlamaPipeRunner(port, pmesh, num_microbatches=2, schedule=schedule,
                         optimizer=pt.optimizer.AdamW(
                             1e-2, parameters=port.parameters()))
    return rr, pr, np_state


@pytest.mark.parametrize("schedule,layers", RUNNER_CASES,
                         ids=[s for s, _ in RUNNER_CASES])
def test_runner_two_adamw_steps_match_reference(schedule, layers):
    rr, pr, _ = _runner_pair(schedule, layers, False)
    ids = np.random.RandomState(0).randint(0, 64, (4, 8))
    for _ in range(2):
        want = rr.step(jnp.asarray(ids, jnp.int32), jnp.asarray(ids))
        got = pr.step(torch.from_numpy(ids), torch.from_numpy(ids))
        _close(got, want)
    for group, rgroup in ((pr.embed_params, rr.embed_params),
                          (pr.stage_params, rr.stage_params),
                          (pr.head_params, rr.head_params)):
        assert set(group) == set(rgroup)
        for k, t in group.items():
            _close(t, rgroup[k], PARAM_TOL)


@pytest.mark.parametrize("schedule", ["1F1B", "ZB"])
def test_tied_runner_gradients_match_the_model(schedule):
    """Tied embeddings under 1F1B and ZB: the head's embedding cotangent
    joins the embedding's gradient (the model's own autograd on the same
    weights is the reference here; the toy's tied cases above hold the
    schedules to the reference's)."""
    pt.seed(0)
    model = pt.models.llama_tiny(device="cpu", num_hidden_layers=2,
                                 tie_word_embeddings=True, **KW)
    mesh = dist.ProcessMesh(shape=[2], dim_names=["pp"], device="cpu")
    runner = LlamaPipeRunner(model, mesh, 2, schedule=schedule)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (4, 8)))
    loss, (demb, dstage, dhead) = runner.grads(ids, ids)
    want, _ = model(ids, labels=ids)
    want.backward()
    _close(loss, want.detach().numpy())
    _close(demb["weight"], model.llama.embed_tokens.weight.grad.numpy())
    _close(dstage["self_attn.q_proj.weight"][1, 0],
           model.llama.layers[1].self_attn.q_proj.weight.grad.numpy())
    _close(dhead["norm"], model.llama.norm.weight.grad.numpy())


def test_runner_layout_flag_and_converter():
    """The stacked layout is Shard(0) on pp; FLAGS_pipeline_schedule picks
    the schedule; tied embeddings refuse FThenB; the converter fills a
    runner from a reference state as the runner stacks its own model."""
    _, pr, np_state = _runner_pair("VPP", 4, False)
    q = pr.stage_params["self_attn.q_proj.weight"]
    assert tuple(q.shape[:3]) == (2, 2, 1)
    assert q.placements == [dist.Shard(0)]
    # [s=1, c=1, j=0] is virtual stage 3: layer 3
    np.testing.assert_array_equal(
        q[1, 1, 0].numpy(), np_state["llama.layers.3.self_attn.q_proj.weight"])
    before = {k: v.clone() for k, v in pr.stage_params.items()}
    for t in pr.stage_params.values():
        t.zero_()
    load_reference_pipe(pr, np_state)
    for k, t in pr.stage_params.items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
    port = pt.models.llama_tiny(device="cpu", **KW)
    mesh = dist.ProcessMesh(shape=[2], dim_names=["pp"], device="cpu")
    pt.set_flags({"FLAGS_pipeline_schedule": "1f1b"})
    try:
        assert LlamaPipeRunner(port, mesh, 2).schedule == "1F1B"
    finally:
        pt.set_flags({"FLAGS_pipeline_schedule": "FThenB"})
    tied = pt.models.llama_tiny(device="cpu", tie_word_embeddings=True, **KW)
    with pytest.raises(NotImplementedError, match="1F1B"):
        LlamaPipeRunner(tied, mesh, 2)
    with pytest.raises(ValueError, match="schedule"):
        LlamaPipeRunner(port, mesh, 2, schedule="nope")
