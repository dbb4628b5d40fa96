"""The port's training guards against the JAX package's: TrainSupervisor
(resilience/supervisor.py) and the step Watchdog
(distributed/watchdog.py). The same scripted runs go through both
packages' supervisors and must skip, count, save, raise and resume alike;
then a supervised LlamaPipeRunner (tiny, 1F1B) skips an injected
non-finite step with its parameters restored, is preempted, and resumes
with the loss an uninterrupted run has. Both watchdogs fire on a step
that sleeps past their timeout and stay quiet on quick steps."""

import os
import signal
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import watchdog as rwd
from paddle_tpu.resilience import faults as rfaults
from paddle_tpu.resilience import supervisor as rsup
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import watchdog as wd
from paddle_tpu_torch.parallel.llama_pipeline import LlamaPipeRunner
from paddle_tpu_torch.resilience import faults, supervisor as sup
from torch_one_thread import one_torch_thread  # noqa: F401

PKGS = [(rsup, rfaults), (sup, faults)]


def _script(mod, fmod):
    """One scripted run: losses with NaN/Inf, a restore_fn, an injected
    non-finite step, checkpoint cadence, a preemption and a resume."""
    log = []
    losses = iter([1.0, float("nan"), 0.8, float("inf"), 0.6, 0.5, 0.4])
    s = mod.TrainSupervisor(lambda: next(losses), save_fn=log.append,
                            load_fn=lambda: 4,
                            restore_fn=lambda: log.append("restore"),
                            checkpoint_every=2)
    out = [s.step() for _ in range(5)]
    with fmod.injected_faults("train.step_nonfinite:1:FaultInjected"):
        out.append(s.step())
    s.request_preemption()
    with pytest.raises(mod.Preempted) as ei:
        s.step()
    out += [ei.value.code, ei.value.step, str(ei.value), s.resume(),
            s.step_count, s.nonfinite_skips]
    streak = mod.TrainSupervisor(lambda: float("nan"),
                                 max_consecutive_nonfinite=1)
    out.append(streak.step())
    with pytest.raises(mod.NonFiniteLossError, match="consecutive"):
        streak.step()
    return out, log


def test_supervisor_runs_as_the_reference():
    assert _script(*PKGS[1]) == _script(*PKGS[0])


def test_sigterm_grace_and_counter():
    obs.enable()
    try:
        before = obs.get_registry().get("train_preemptions_total").value
        saves = []
        s = sup.TrainSupervisor(lambda: 1.0, save_fn=saves.append)
        s.install_signal_handlers()
        try:
            s.step()
            os.kill(os.getpid(), signal.SIGTERM)
            with pytest.raises(sup.Preempted):
                s.step()
        finally:
            s.restore_signal_handlers()
        assert saves == [1]
        assert obs.get_registry().get(
            "train_preemptions_total").value == before + 1
    finally:
        obs.disable()


def test_supervised_pipeline_skips_preempts_and_resumes():
    pt.seed(0)
    model = pt.models.llama_tiny(device="cpu", vocab_size=64, hidden_size=32,
                                 intermediate_size=64, num_attention_heads=2,
                                 num_key_value_heads=2)
    mesh = dist.ProcessMesh(shape=[2], dim_names=["pp"], device="cpu")
    runner = LlamaPipeRunner(model, mesh, 2, schedule="1F1B",
                             optimizer=pt.optimizer.AdamW(
                                 1e-2, parameters=model.parameters()))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (4, 8)))
    ckpt, raw = {}, []

    def params():
        return {f"{g}.{k}": v for g, tree in runner._groups()
                for k, v in tree.items()}

    def save(step):
        ckpt.update({k: v.clone() for k, v in params().items()},
                    __step__=step)

    def load():
        with torch.no_grad():
            for k, v in params().items():
                v.copy_(ckpt[k])
        return ckpt["__step__"]

    def step(tok):
        loss = runner.step(tok, tok)
        raw.append(float(loss))
        return loss

    s = sup.TrainSupervisor(step, save_fn=save, load_fn=load,
                            restore_fn=load, checkpoint_every=1)
    assert s.step(ids) is not None
    kept = {k: v.clone() for k, v in params().items()}
    with faults.injected_faults("train.step_nonfinite:1:FaultInjected"):
        assert s.step(ids) is None
    assert s.nonfinite_skips == 1
    for k, v in params().items():
        torch.testing.assert_close(v, kept[k], rtol=0, atol=0)
    s.request_preemption()
    with pytest.raises(sup.Preempted) as ei:
        s.step(ids)
    assert ei.value.code == 0 and ei.value.step == 1
    for v in params().values():
        v.data.zero_()
    resumed = sup.TrainSupervisor(step, load_fn=load)
    assert resumed.resume() == 1
    # the skipped step's loss is the uninterrupted run's second loss
    assert resumed.step(ids) == raw[1]


@pytest.mark.parametrize("mod", [rwd, wd], ids=["reference", "port"])
def test_watchdog_fires_on_a_hung_step(mod, capsys):
    quiet = mod.Watchdog(timeout=2.0, poll_interval=0.05)
    with quiet:
        for _ in range(3):
            with quiet.step_guard():
                pass
    assert not quiet.fired and quiet.step_count == 3
    fired = []
    dog = mod.Watchdog(timeout=0.2, poll_interval=0.05,
                       on_timeout=lambda w: fired.append(w.step_count))
    with dog:
        with dog.step_guard():
            time.sleep(0.5)
    assert dog.fired and fired == [0]
    err = capsys.readouterr().err
    assert "no step completion" in err and "--- thread" in err
    glob = mod.enable_comm_watchdog(timeout=60)
    try:
        assert glob is mod.enable_comm_watchdog() and not glob.fired
    finally:
        glob.stop()            # the process-wide one: no dump later on
        mod._global_watchdog = None
