"""Weight publishing on the port (``dtf_tpu_torch.publish``,
``hooks.PublishHook``).

Ported one for one from ``tests/test_serve_swap.py`` (the same
assertions): monotone versions and a crash mid-publish that leaves the
previous version servable (the orphan's number never reused, by the live
publisher or a restarted one); a corrupt newest version taken past by the
guarded walk, refused when named, skipped once by the watcher. New here:
the digest fails on any truncated or flipped byte of the port's own
files, or a stray one; ``PublishHook`` on a
tiny port ``Trainer`` publishes every N steps and the final step once,
warns and trains on when a publish fails, and lets an injected crash
through.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from dtf_tpu_torch.core import train as tr
from dtf_tpu_torch.fault.inject import (FaultHook, FaultPlan, InjectedCrash,
                                        corrupt_publish_version)
from dtf_tpu_torch.hooks import PublishHook, StopAtStepHook
from dtf_tpu_torch.loop import Trainer
from dtf_tpu_torch import optim
from dtf_tpu_torch.publish import (MANIFEST_BASENAME, ParamPublisher,
                                   PublishWatcher, dir_digest,
                                   load_published, read_manifest)


def _tree(k: float) -> dict:
    return {"w": torch.arange(8.0) * k, "b": torch.ones(3) * k}


def test_publish_monotone_versions_and_crash_mid_publish(tmp_path):
    d = str(tmp_path / "pub")
    pub = ParamPublisher(d, keep=4)
    assert pub.publish(2, _tree(1)) == 1
    assert pub.publish(4, _tree(2)) == 2
    m = read_manifest(d)
    assert m["version"] == 2 and m["step"] == 4
    assert m["history"]["1"]["step"] == 2

    # crash in the widest window (data durable, manifest not yet flipped):
    # the previous version keeps serving, the attempt's dir is an orphan
    hook = FaultHook(FaultPlan.parse("crash_in_publish@6"), publisher=pub,
                     emit=lambda line: None)
    with pytest.raises(InjectedCrash):
        pub.publish(6, _tree(3))
    assert hook.fired
    assert read_manifest(d)["version"] == 2
    v, s, params = load_published(d)
    assert (v, s) == (2, 4)
    assert float(params["w"][1]) == 2.0

    # the orphan's number is never reused — by the live publisher and by
    # a restarted one
    assert pub.publish(6, _tree(3)) == 4
    assert ParamPublisher(d, keep=4).publish(8, _tree(5)) == 5
    v, _, params = load_published(d)
    assert v == 5 and float(params["w"][1]) == 5.0


def test_publish_corrupt_guarded_walk_vs_explicit_no_fallback(tmp_path,
                                                              caplog):
    d = str(tmp_path / "pub")
    pub = ParamPublisher(d)
    pub.publish(1, _tree(1))
    pub.publish(2, _tree(2))
    corrupt_publish_version(d, 2, mode="garbage")
    # latest: the guarded walk warns past the corrupt newest version
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        v, _, params = load_published(d)
    assert v == 1 and float(params["w"][1]) == 1.0
    assert any("unservable" in r.message for r in caplog.records)
    # explicit: the caller asked for exactly that version — no fallback
    with pytest.raises(ValueError, match="digest"):
        load_published(d, version=2)
    # the watcher skips it once and remembers (no warning every poll)
    w = PublishWatcher(d, applied_version=1)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        assert w.load_new() is None and w.skipped == {2}
        assert w.poll() is None
    assert len([r for r in caplog.records if "skipping" in r.message]) == 1
    # a fresh (uncorrupt) republish is picked up normally
    pub.publish(3, _tree(3))
    got = w.load_new()
    assert got is not None and got[0] == 3


@pytest.mark.parametrize("damage", ["truncate", "garbage", "flip_last",
                                    "extra_file"])
def test_digest_fails_on_any_damage(tmp_path, damage):
    d = str(tmp_path / "pub")
    ParamPublisher(d).publish(1, _tree(1))
    vdir = os.path.join(d, "1")
    want = read_manifest(d)["digest"]
    assert dir_digest(vdir) == want
    if damage in ("truncate", "garbage"):
        corrupt_publish_version(d, 1, mode=damage)
    elif damage == "flip_last":
        path = os.path.join(vdir, "params.pt")
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            b = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([b[0] ^ 1]))
    else:
        with open(os.path.join(vdir, "stray"), "w") as f:
            f.write("x")
    assert dir_digest(vdir) != want
    with pytest.raises(ValueError, match="digest"):
        load_published(d, version=1)
    with pytest.raises(RuntimeError, match="unservable"):
        load_published(d)


def _tiny_trainer(tmp_path, publisher, every_n, stop):
    """A Trainer over a two-leaf 'model' with a deterministic loss: every
    leaf moves each step."""
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(0.5)
        model.bias.fill_(-0.25)
    tx = optim.sgd(0.1)

    def loss_fn(params, batch, rng):
        loss = sum((p * p).mean() for p in params.values()) * batch["x"][0]
        return loss, tr.LossAux()

    state = tr.create_train_state(model, tx, 0)
    step = tr.make_train_step(loss_fn, tx)
    batches = ({"x": np.ones((1,), np.float32)} for _ in iter(int, 1))
    hooks = [PublishHook(publisher, every_n=every_n), StopAtStepHook(stop)]
    return Trainer(step, "cpu", hooks).fit(state, batches,
                                           max_steps=stop), hooks[0]


def test_publish_hook_on_a_trainer(tmp_path):
    """Every 2 steps of 5, and the final step at the end: versions at
    steps 2, 4 and 5, each the parameters of its step."""
    d = str(tmp_path / "pub")
    state, _ = _tiny_trainer(tmp_path, ParamPublisher(d, keep=8), 2, 5)
    m = read_manifest(d)
    assert m["version"] == 3
    assert [m["history"][str(v)]["step"] for v in (1, 2, 3)] == [2, 4, 5]
    _, step, params = load_published(d)
    assert step == 5
    for n, p in state.params.items():
        assert torch.equal(params[n], p.detach()), n
    # the last periodic publish covering the end: no second publish
    d2 = str(tmp_path / "pub2")
    _tiny_trainer(tmp_path, ParamPublisher(d2), 2, 4)
    assert read_manifest(d2)["version"] == 2
    with pytest.raises(ValueError, match="every_n"):
        PublishHook(None, every_n=0)


def test_publish_hook_warns_and_trains_on(tmp_path, caplog):
    class Broken:
        def publish(self, step, params):
            raise OSError("disk full")

    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        state, hook = _tiny_trainer(tmp_path, Broken(), 1, 3)
    assert state.step == 3
    # each step's publish, and the end's retry of the final step (the
    # last periodic publish did not cover it)
    assert len([r for r in caplog.records
                if "publish at step" in r.message]) == 4
    # no publisher (a process that does not save): inert
    state, _ = _tiny_trainer(tmp_path, None, 1, 2)
    assert state.step == 2


def test_publish_hook_lets_an_injected_crash_through(tmp_path):
    """crash_in_publish: the trainer dies mid-publish, and the loop's end
    does not publish again (a killed host would not)."""
    d = str(tmp_path / "pub")
    pub = ParamPublisher(d)
    FaultHook(FaultPlan.parse("crash_in_publish@2"), publisher=pub,
              emit=lambda line: None)
    with pytest.raises(InjectedCrash):
        _tiny_trainer(tmp_path, pub, 1, 4)
    m = read_manifest(d)
    assert m["version"] == 1 and m["step"] == 1
    assert sorted(os.listdir(d)) == ["1", "2", MANIFEST_BASENAME]
    with open(os.path.join(d, MANIFEST_BASENAME)) as f:
        assert json.load(f)["history"].keys() == {"1"}
