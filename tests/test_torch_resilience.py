"""The port's fault harness and retry policies (resilience/faults.py,
retry.py) against the JAX package's.

Both are copies of pure-Python modules, so parity means the same behaviour
under the same spec: the same sites, the same parse errors, the same hits
that fire, the same seeded schedules and backoffs, the same breaker states,
and the same counters in each package's observability catalog. The fault
sites the serving engine calls must fire there too.
"""

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import retry as jretry
import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.resilience import faults, retry
from torch_one_thread import one_torch_thread  # noqa: F401

BOTH = ((jfaults, jretry, jobs), (faults, retry, obs))


@pytest.fixture(autouse=True)
def fresh():
    for f, _, o in BOTH:
        f.disarm()
        o.get_registry().reset()
        o.enable()
    yield
    for f, _, o in BOTH:
        f.disarm()
        o.disable()
        o.get_registry().reset()


def _both(scenario):
    """scenario(faults, retry, observability) for each package; the two
    results must be equal."""
    ref, port = (scenario(*mods) for mods in BOTH)
    assert port == ref
    return port


def _counts(o, name):
    """The nonzero samples of a counter (a reset registry keeps its
    children at zero)."""
    fam = o.get_registry().get(name)
    return {} if fam is None else {k: c.value
                                   for k, c in fam.children().items()
                                   if c.value}


def test_sites_and_exception_classes_are_the_reference_registry():
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert set(faults._EXC_CLASSES) == set(jfaults._EXC_CLASSES)
    assert retry.DEFAULT_TRANSIENT == jretry.DEFAULT_TRANSIENT


@pytest.mark.parametrize("spec,error", [
    ("not.a.site:1:OSError", "unknown fault site"),
    ("store.get:1:KeyboardInterrupt", "exception class"),
    ("store.get:1", "malformed")])
def test_bad_specs_raise_alike(spec, error):
    def scenario(f, r, o):
        with pytest.raises(ValueError, match=error) as ei:
            f.parse_spec(spec)
        return str(ei.value)
    _both(scenario)


def test_nth_hit_and_counters():
    def scenario(f, r, o):
        fired = []
        with f.injected_faults("store.get:2:TimeoutError;serve.admit:1:"
                               "FaultInjected"):
            for site in ("store.get",) * 3 + ("serve.admit",) * 2:
                try:
                    f.fault_point(site, rid=1)
                    fired.append(None)
                except Exception as e:  # noqa: BLE001
                    fired.append((type(e).__name__, str(e)))
            hits, injected = f.hit_counts(), f.injected_counts()
        return (fired, hits, injected, f.hit_counts(),
                _counts(o, "fault_injected_total"))
    fired, hits, injected, after, counted = _both(scenario)
    assert [x is not None for x in fired] == [False, True, False, True,
                                              False]
    assert hits == {"store.get": 3, "serve.admit": 2}
    assert after == {}                     # disarmed on leaving the block


def test_seeded_random_schedule():
    def scenario(f, r, o):
        with f.injected_faults("serve.admit:rand(0.4)@7:FaultInjected"):
            return [f.check("serve.admit") for _ in range(40)]
    fired = _both(scenario)
    assert any(fired) and not all(fired)


def test_flag_arms_the_harness():
    pt.set_flags({"FLAGS_fault_injection": "serve.hostsync_read:1:OSError"})
    try:
        with pytest.raises(OSError, match="injected fault"):
            faults.fault_point("serve.hostsync_read")
    finally:
        pt.set_flags({"FLAGS_fault_injection": ""})
    faults.fault_point("serve.hostsync_read")      # disarmed again
    try:
        with pytest.raises(ValueError):
            pt.set_flags({"FLAGS_fault_injection": "nope:1:OSError"})
    finally:
        pt.set_flags({"FLAGS_fault_injection": ""})


def _flaky(fail_times, exc=TimeoutError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise exc(f"boom {calls['n']}")
        return "ok"
    return fn, calls


@pytest.mark.parametrize("fail_times,exc,attempts", [
    (2, TimeoutError, 4), (99, TimeoutError, 3), (99, ValueError, 5),
    (1, ConnectionError, 2)])
def test_retry_policy_alike(fail_times, exc, attempts):
    def scenario(f, r, o):
        sleeps = []
        p = r.RetryPolicy(max_attempts=attempts, base_delay=0.01,
                          jitter=0.5, seed=3, sleep=sleeps.append)
        fn, calls = _flaky(fail_times, exc)
        try:
            out = p.call(fn, op="unit")
        except Exception as e:  # noqa: BLE001
            out = (type(e).__name__, str(e))
        return (out, calls["n"], p.last_retries, sleeps,
                [p.backoff(i) for i in (1, 2, 3)],
                _counts(o, "resilience_retries_total"),
                _counts(o, "resilience_retry_giveups_total"))
    _both(scenario)


def test_retry_deadline_alike():
    def scenario(f, r, o):
        clock = {"t": 0.0}
        p = r.RetryPolicy(max_attempts=100, base_delay=1.0, jitter=0.0,
                          deadline=2.5,
                          sleep=lambda s: clock.__setitem__(
                              "t", clock["t"] + s),
                          clock=lambda: clock["t"])
        fn, calls = _flaky(99)
        with pytest.raises(TimeoutError):
            p.call(fn, op="unit")
        return calls["n"], clock["t"]
    assert _both(scenario)[0] == 2


def test_circuit_breaker_cycle_alike():
    def scenario(f, r, o):
        clock = {"t": 0.0}
        cb = r.CircuitBreaker(failure_threshold=2, reset_timeout=10.0,
                              clock=lambda: clock["t"], op="store")
        boom = {"on": True}

        def fn():
            if boom["on"]:
                raise TimeoutError("down")
            return "ok"
        trace = []
        for t, on in ((0.0, True), (1.0, True), (2.0, True), (5.0, False),
                      (11.0, True), (12.0, True), (23.0, False)):
            clock["t"], boom["on"] = t, on
            try:
                trace.append(cb.call(fn))
            except (TimeoutError, r.CircuitOpenError) as e:
                trace.append(type(e).__name__)
            trace.append(cb.state)
        return trace, _counts(o, "resilience_circuit_open_total")
    trace, opened = _both(scenario)
    assert trace[-2:] == ["ok", retry.CircuitBreaker.CLOSED]


def test_engine_fault_sites_fire_in_the_port():
    """The serving engine's seams: an injected admission fault defers and
    requeues the request, which is then served in full."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    pt.seed(0)
    model = pt.models.llama_tiny(num_hidden_layers=1, device="cpu")
    eng = ContinuousBatchingEngine(model, num_blocks=32, block_size=8,
                                   max_batch=2, prefill_buckets=(16,))
    with faults.injected_faults("serve.admit:1:FaultInjected;"
                                "serve.hostsync_read:1:TimeoutError"):
        rid = eng.add_request(np.arange(6), max_new_tokens=5)
        out = eng.run()
        assert faults.injected_counts() == {"serve.admit": 1,
                                            "serve.hostsync_read": 1}
    assert len(out[rid]) == 5
    deferred = _counts(obs, "serving_deferred_total")
    assert deferred == {(("reason", "admit_fault"),): 1}
    assert _counts(obs, "serving_hostsync_retries_total") == {(): 1}
