"""The training verbs of ``DTF_FAULT_INJECT`` on the port
(``dtf_tpu_torch.fault.inject``) against the JAX package's.

Ported one for one (the reference's own checks, run on both packages):
``FaultPlan`` parses, rejects and routes ``DTF_FAULT_INJECT`` exactly as
``dtf_tpu.fault.inject.FaultPlan`` does (``tests/test_elastic.py``'s
parsing table, extended). New here: each verb fires at its seeded step
on a tiny port ``train_gpt`` in a subprocess (``crash``, ``kill``,
``sigterm``, ``sigterm_in_save``, ``wedge``, the last reaped with
SIGKILL after its JSON line), ``crash_in_publish`` in process, ``crash``
on the port's MNIST launcher; ``crash@2`` stops the port's and the JAX
``train_gpt`` at the same step with the same exit code and the same
checkpoint left behind, and resuming from it equals the run without a
fault; a data-stream verb raises in the launchers.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from dtf_tpu.fault import inject as jinject
from dtf_tpu_torch import distributed, train_gpt
from dtf_tpu_torch.checkpoint import Checkpointer
from dtf_tpu_torch.fault import inject as tinject
from dtf_tpu_torch.publish import load_published, read_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tiny run every verb fires in: 5 steps, a periodic save every 3
TINY = ["--device=cpu", "--size=tiny", "--batch_size=4", "--seq_len=32",
        "--log_every=1", "--checkpoint_every=3"]
STEPS = 5


@pytest.mark.parametrize("spec", [
    "kill@12:host=1", "wedge@7", "sigterm@5", "sigterm_in_save@3",
    "crash@2", "crash_in_publish@4", "crash@0:host=0", " crash@2 ",
    "kill", "melt@3", "kill@-1", "kill@3:chip=1", "crash@x",
    "wedge_replica@1", "crash@2:host=x",
])
def test_fault_plan_parses_as_jax(spec):
    def run(mod):
        try:
            plan = mod.FaultPlan.parse(spec)
        except ValueError as e:
            return "ValueError", str(e)
        return (plan.kind, plan.step, plan.host, plan.applies_to(0),
                plan.applies_to(1))

    assert run(tinject) == run(jinject)


@pytest.mark.parametrize("env", [
    {}, {"DTF_FAULT_INJECT": ""}, {"DTF_FAULT_INJECT": "kill@3:host=1"},
    {"DTF_FAULT_INJECT": "crash_in_publish@4"},
    {"DTF_FAULT_INJECT": "wedge_in_swap@0:replica=1"},
    {"DTF_FAULT_INJECT": "stall_source@2"},
    {"DTF_FAULT_INJECT": "corrupt_record@1:source=0"},
    {"DTF_FAULT_INJECT": "bogus@1"},
], ids=["unset", "empty", "trainer", "publish", "serve", "stall",
        "corrupt_record", "unknown"])
def test_fault_plan_from_env_as_jax(env):
    def run(mod):
        try:
            plan = mod.FaultPlan.from_env(env)
        except ValueError as e:
            return "ValueError", str(e)
        return None if plan is None else (plan.kind, plan.step, plan.host)

    assert run(tinject) == run(jinject)
    assert tinject.KINDS == jinject.KINDS
    assert tinject.STREAM_KINDS == jinject.STREAM_KINDS


def test_maybe_hook_scopes_and_raises_on_stream_verbs():
    """The launchers' one-liner: a hook for this host's training verb,
    None for another host's or a serve verb (as the reference's), and —
    the port's own rule — a data-stream verb raises instead of being
    accepted and ignored."""
    env = {"DTF_FAULT_INJECT": "crash@2:host=1"}
    assert tinject.maybe_hook(host_index=0, env=env) is None
    hook = tinject.maybe_hook(host_index=1, env=env)
    assert (hook.plan.kind, hook.plan.step, hook.host_index) == \
        ("crash", 2, 1)
    assert tinject.maybe_hook(env={"DTF_FAULT_INJECT":
                                   "wedge_replica@1"}) is None
    for spec in ("stall_source@2", "corrupt_record@1:source=0"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tinject.maybe_hook(env={"DTF_FAULT_INJECT": spec})


def _env(base, **extra):
    return {**base, "PYTHONPATH": ROOT, **extra}


def _fired(stdout: str) -> list:
    return [json.loads(r) for r in stdout.splitlines()
            if r.startswith('{"fault_inject"')]


def _steps(logdir) -> list:
    d = os.path.join(logdir, "ckpt")
    return sorted(int(n) for n in os.listdir(d) if n.isdigit()) \
        if os.path.isdir(d) else []


#: verb -> (the exit code, the checkpoints left, the step it stops at)
VERBS = {
    # raised at step 2; the loop's end hooks save the step it died at
    "crash@2": (1, [2], None),
    # no end hooks: only the periodic save of step 3 survives
    "kill@4": (-signal.SIGKILL, [3], None),
    # graceful: PreemptionHook saves the exact step and stops cleanly
    "sigterm@2": (0, [2], 2),
    # SIGTERM from inside the periodic save of step 3: that step
    "sigterm_in_save@3": (0, [3], 3),
}


@pytest.mark.parametrize("verb", [*VERBS, "wedge@2"])
def test_training_verb_fires_at_its_step(verb, tmp_path,
                                         cpu_sim_subprocess_env):
    cmd = [sys.executable, "-m", "dtf_tpu_torch.train_gpt", *TINY,
           f"--train_steps={STEPS}", f"--logdir={tmp_path}"]
    env = _env(cpu_sim_subprocess_env, DTF_FAULT_INJECT=verb)
    kind, _, step = verb.partition("@")
    if kind == "wedge":
        # alive and never completing another step: reaped with SIGKILL
        # once its JSON line is out
        proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        try:
            line = proc.stdout.readline()
            while line and not line.startswith('{"fault_inject"'):
                line = proc.stdout.readline()
            time.sleep(2 * tinject.FaultHook.WEDGE_POLL_S)
            assert proc.poll() is None, "the wedged run exited"
        finally:
            proc.kill()
            proc.wait(timeout=30)
        note = json.loads(line)
        assert (note["kind"], note["step"]) == ("wedge", 2)
        assert _steps(tmp_path) == []
        return
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    rc, ckpts, stop = VERBS[verb]
    assert proc.returncode == rc, proc.stderr[-2000:]
    notes = _fired(proc.stdout)
    assert len(notes) == 1 and notes[0]["kind"] == kind
    assert notes[0]["step"] == int(step)
    assert notes[0]["fault_inject"] == ("sigterm_in_save"
                                        if kind == "sigterm_in_save"
                                        else "firing")
    assert _steps(tmp_path) == ckpts
    if stop is not None:
        assert f"done: step={stop}" in proc.stdout
    if kind == "crash":
        assert "InjectedCrash: injected crash at step 2" in proc.stderr


def test_crash_in_publish_leaves_the_previous_version(tmp_path,
                                                      monkeypatch):
    """``crash_in_publish@4`` on ``train_gpt --publish_every 2``: version
    1 (step 2) commits; the publish of step 4 dies between its durable
    data and the manifest, so the manifest and the guarded load still
    name version 1; a relaunch resumes and publishes version 3 — the
    orphan's number is never reused."""
    pub = str(tmp_path / "pub")
    flags = TINY + [f"--logdir={tmp_path}", f"--publish_dir={pub}",
                    "--publish_every=2"]
    monkeypatch.setenv("DTF_FAULT_INJECT", "crash_in_publish@4")
    with pytest.raises(tinject.InjectedCrash, match="mid-publish of "
                                                    "version 2"):
        train_gpt.run(flags + ["--train_steps=4"])
    m = read_manifest(pub)
    assert m["version"] == 1 and m["step"] == 2
    assert os.path.isdir(os.path.join(pub, "2"))       # the orphan
    assert load_published(pub)[:2] == (1, 2)
    monkeypatch.delenv("DTF_FAULT_INJECT")
    state, _ = train_gpt.run(flags + ["--train_steps=6"])
    assert state.step == 6
    assert load_published(pub)[:2] == (3, 6)


def test_crash_on_the_mnist_launcher(tmp_path, monkeypatch):
    """``python -m dtf_tpu_torch.distributed`` arms the same hook: crash@2
    stops it at step 2, and the loop's end save leaves that step."""
    monkeypatch.setenv("DTF_FAULT_INJECT", "crash@2")
    with pytest.raises(tinject.InjectedCrash, match="at step 2"):
        distributed.run(["--backend=cpu", "--device=cpu",
                         "--train_steps=4", "--batch_size=32",
                         "--checkpoint_every=3", f"--logdir={tmp_path}"])
    assert _steps(tmp_path) == [2]


def test_crash_matches_the_jax_launcher_and_resumes(tmp_path,
                                                    cpu_sim_subprocess_env):
    """crash@2 on the JAX ``scripts/train_gpt.py`` and on the port's: the
    same firing step, exit code and checkpoint left behind. Resuming the
    port's run from that checkpoint then ends where the run without a
    fault ends, bit for bit."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    flags = ["--size=tiny", "--batch_size=4", "--seq_len=32",
             "--train_steps=4", "--checkpoint_every=3"]
    env = _env(cpu_sim_subprocess_env, DTF_FAULT_INJECT="crash@2")
    # the JAX launcher runs beside the port's runs
    jproc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "train_gpt.py"),
         *flags, f"--logdir={jdir}"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tproc = subprocess.run(
            [sys.executable, "-m", "dtf_tpu_torch.train_gpt", *flags,
             "--device=cpu", f"--logdir={tdir}"], cwd=str(tmp_path),
            env=env, capture_output=True, text=True, timeout=120)
        left = _steps(tdir)
        resumed, _ = train_gpt.run(flags + ["--device=cpu",
                                            f"--logdir={tdir}"])
        clean, _ = train_gpt.run(flags + ["--device=cpu",
                                          f"--logdir={tmp_path / 'clean'}"])
        jout, jerr = jproc.communicate(timeout=300)
    finally:
        jproc.kill()
    assert tproc.returncode == jproc.returncode == 1, jerr[-2000:]
    tnote, jnote = _fired(tproc.stdout), _fired(jout)
    assert [(n["kind"], n["step"]) for n in tnote] == \
        [(n["kind"], n["step"]) for n in jnote] == [("crash", 2)]
    assert left == _steps(jdir) == [2]
    assert resumed.step == clean.step == 4
    assert Checkpointer(tdir / "ckpt").latest_step() == 4
    for name, p in clean.params.items():
        assert torch.equal(resumed.params[name], p), name
