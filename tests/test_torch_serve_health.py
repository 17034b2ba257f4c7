"""The port's replica health (``dtf_tpu_torch.serve.health``) and serve
fault plans (``dtf_tpu_torch.fault.inject``) against the JAX package's,
host arithmetic only.

Both trackers are fed the same seeded script of tick durations (fast,
slow, past the wedge bar), engine faults, forced quarantines, routability
checks and clock advances under one injected clock; after every call the
return value, ``states()``, ``transitions``, ``counters``, every
replica's ``rank`` and ``threshold_s`` and ``quarantined_eta_s()`` are
equal. ``HealthConfig``, ``ServeFaultPlan.parse`` and ``from_env`` raise
the reference's errors; the serve verbs whose targets are not ported
(hot-swap, the serve-log sink, the event log) raise when installed; and
the ported verbs fire on a scheduler of a fake engine.
"""

import json

import numpy as np
import pytest

from dtf_tpu.fault import inject as jinject
from dtf_tpu.serve import health as jhealth
from dtf_tpu_torch.fault import inject as tinject
from dtf_tpu_torch.serve import Request, Scheduler
from dtf_tpu_torch.serve import health as thealth


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


_CONFIGS = {
    "default": {},
    "tight": dict(slow_factor=5.0, min_slow_s=1.0, wedge_s=5.0,
                  quarantine_after=2, probation_delay_s=50.0,
                  probation_ticks=2, probation_delay_max_s=120.0),
    "patient": dict(degrade_after=2, quarantine_after=4, keep=4,
                    probation_backoff=3.0, probation_delay_s=5.0),
}


def _view(tr, n):
    return {"states": tr.states(), "transitions": list(tr.transitions),
            "counters": dict(tr.counters),
            "rank": [tr.rank(i) for i in range(n)],
            "threshold": [tr.threshold_s(i) for i in range(n)],
            "eta": tr.quarantined_eta_s()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_tracker_equals_jax_call_by_call(config, seed):
    n = 3
    clock = _Clock()
    want = jhealth.HealthTracker(
        n, jhealth.HealthConfig(**_CONFIGS[config]), clock=clock)
    got = thealth.HealthTracker(
        n, thealth.HealthConfig(**_CONFIGS[config]), clock=clock)
    cfg = got.cfg
    rng = np.random.default_rng(seed)
    for step in range(400):
        i = int(rng.integers(n))
        op = rng.choice(["tick", "tick", "tick", "tick", "fault",
                         "quarantine", "routable", "advance"],
                        p=[0.3, 0.15, 0.1, 0.05, 0.05, 0.05, 0.2, 0.1])
        if op == "tick":
            dur = float(rng.choice([
                rng.uniform(0.0, 0.2), rng.uniform(0.9, 1.2) * cfg.min_slow_s,
                rng.uniform(1.0, 2.0) * cfg.wedge_s]))
            args = ("note_tick", i, dur)
        elif op == "fault":
            args = ("note_fault", i, RuntimeError(f"engine fault {step}"))
        elif op == "quarantine":
            args = ("quarantine", i, f"forced {step}")
        elif op == "routable":
            args = ("routable", i)
        else:
            clock.advance(float(rng.uniform(0.0, 2.0)
                                * cfg.probation_delay_s))
            args = None
        if args is not None:
            assert (getattr(got, args[0])(*args[1:])
                    == getattr(want, args[0])(*args[1:])), (step, args)
        assert _view(got, n) == _view(want, n), (step, args)
    assert got.counters["quarantines"] > 0 and got.counters["probations"] > 0


@pytest.mark.parametrize("kw", [
    dict(degrade_after=0), dict(degrade_after=3, quarantine_after=2),
    dict(probation_ticks=0), dict(min_slow_s=0.0),
    dict(min_slow_s=5.0, wedge_s=1.0), dict(probation_backoff=0.5),
], ids=["degrade0", "degrade_gt_quarantine", "probation0", "slow0",
        "wedge_lt_slow", "backoff"])
def test_health_config_errors_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jhealth.HealthConfig(**kw)
    with pytest.raises(ValueError) as got:
        thealth.HealthConfig(**kw)
    assert str(got.value) == str(want.value)


def test_tracker_needs_a_replica():
    with pytest.raises(ValueError, match="n_replicas=0"):
        thealth.HealthTracker(0)


@pytest.mark.parametrize("spec", [
    "wedge_replica@3:replica=1", "slow_decode@0", "poison_request@2",
    "poison_draft@1", "corrupt_publish@0", "wedge_in_swap@2:replica=0",
    "wedge_replica@3", "bogus@1", "wedge_replica", "wedge_replica@-1",
    "wedge_replica@1:host=0", "slow_decode@x",
])
def test_serve_fault_plan_parses_as_jax(spec):
    def run(mod):
        try:
            plan = mod.ServeFaultPlan.parse(spec)
        except ValueError as e:
            return "ValueError", str(e)
        return plan.kind, plan.tick, plan.replica

    assert run(tinject) == run(jinject)


@pytest.mark.parametrize("env", [
    {}, {"DTF_FAULT_INJECT": ""}, {"DTF_FAULT_INJECT": "kill@3:host=1"},
    {"DTF_FAULT_INJECT": "stall_source@2"},
    {"DTF_FAULT_INJECT": "wedge_replica@5:replica=0"},
    {"DTF_FAULT_INJECT": "poison_request@1"},
    {"DTF_FAULT_INJECT": "slow_decode@2:zone=1"},
], ids=["unset", "empty", "trainer", "stream", "wedge", "poison", "bad"])
def test_serve_fault_plan_from_env_as_jax(env):
    def run(mod):
        try:
            plan = mod.ServeFaultPlan.from_env(env)
        except ValueError as e:
            return "ValueError", str(e)
        return None if plan is None else (plan.kind, plan.tick,
                                          plan.replica)

    assert run(tinject) == run(jinject)
    assert tinject.SERVE_KINDS == jinject.SERVE_KINDS
    assert tinject.ENV_VAR == jinject.ENV_VAR


class _FakeEngine:
    """Host-only engine: every prompt is one chunk (first token =
    prompt[0] % 7), decode emits 1s."""

    n_slots = 2
    max_len = 64
    prefill_chunk = 64
    spec_k = 0

    def prefill_chunk_into(self, slot, prompt, chunk_i, *, start=0, **kw):
        return int(prompt[0]) % 7, False

    def decode(self, **kw):
        return [1] * self.n_slots, [False] * self.n_slots


@pytest.mark.parametrize("kind", ["corrupt_publish", "wedge_in_swap",
                                  "corrupt_log_record",
                                  "crash_in_log_rotate",
                                  "crash_in_event_rotate"])
def test_unported_verbs_raise_when_installed(kind):
    """Every serve verb is ported since: the hot-swap's
    (``tests/test_torch_serve_swap.py`` fires them) and the serve-log
    sink's and the event log's (``tests/test_torch_servelog.py`` and
    ``tests/test_torch_events.py`` fire them) arm without firing on a
    scheduler with nothing to arm."""
    sched = Scheduler(_FakeEngine())
    plan = tinject.ServeFaultPlan(kind, 0)
    assert not thealth.install_serve_fault(plan, sched).fired


def test_wedge_and_poison_fire_on_a_scheduler():
    """wedge_replica sleeps around every decode from the plan's call on;
    poison_request fails its request terminally and keeps serving."""
    clock = _Clock()
    lines = []
    sched = Scheduler(_FakeEngine(), clock=clock)
    wedge = thealth.install_serve_fault(
        tinject.ServeFaultPlan("wedge_replica", 2), sched,
        sleep=clock.advance, wedge_s=3.0, emit=lines.append)
    poison = thealth.install_serve_fault(
        tinject.ServeFaultPlan("poison_request", 1), sched,
        emit=lines.append)
    rids = [sched.submit(Request(prompt=[p], max_new=5)) for p in (3, 4, 5)]
    sched.run_until_idle()
    assert [sched.poll(r)["status"] for r in rids] == ["done", "error",
                                                       "done"]
    assert "InjectedPoison" in sched.poll(rids[1])["error"]
    assert wedge.fired and poison.fired
    assert poison.poison_prompt == (4,)
    # decode calls 3 and on slept 3 s each: ticks 3.. of the 5-token runs
    assert clock.t > 0 and clock.t % 3.0 == 0
    assert sorted((d["kind"], d["fault_inject"])
                  for d in map(json.loads, lines)) == [
        ("poison_request", "firing"), ("poison_request", "poison_armed"),
        ("wedge_replica", "firing")]
