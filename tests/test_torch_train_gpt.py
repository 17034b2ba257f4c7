"""``python -m dtf_tpu_torch.train_gpt`` on the CPU at the tiny size: the
entry point, kill-and-resume, the manifest, ``generate_gpt --logdir``,
the data loaders against the JAX package's, the init distributions
against ``gpt.make_init``'s, and the flags that are not ported yet."""

import ast
import contextlib
import io
import logging
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dtf_tpu.data import formats as jformats
from dtf_tpu.data import synthetic as jsynthetic
from dtf_tpu.models import gpt as jgpt
from dtf_tpu_torch import convert, generate_gpt, train_gpt
from dtf_tpu_torch.checkpoint import Checkpointer, load_model_config
from dtf_tpu_torch.data import formats as tformats
from dtf_tpu_torch.data import synthetic as tsynthetic
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.publish import read_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device=cpu", "--size=tiny", "--batch_size=4", "--seq_len=32",
        "--log_every=1"]


def _run(logdir, steps, *extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return train_gpt.run(TINY + [f"--logdir={logdir}",
                                     f"--train_steps={steps}", *extra])


def test_module_entry_trains_four_steps(tmp_path, cpu_sim_subprocess_env):
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.train_gpt", *TINY,
         "--train_steps=4", f"--logdir={tmp_path}"],
        cwd=ROOT, env=cpu_sim_subprocess_env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "done: step=4"
    assert sum(ln.startswith("[") and "loss=" in ln for ln in lines) >= 4
    assert Checkpointer(tmp_path / "ckpt").latest_step() == 4


def test_kill_and_resume_equals_the_uninterrupted_run(tmp_path):
    """2 steps, a relaunch to 4 — bitwise the run of 4: the relaunch
    restores params, optimizer state and step, and reads the batches of
    steps 3 and 4."""
    straight, _ = _run(tmp_path / "a", 4)
    _run(tmp_path / "b", 2)
    assert Checkpointer(tmp_path / "b" / "ckpt").latest_step() == 2
    resumed, writer = _run(tmp_path / "b", 4)
    assert resumed.step == 4
    assert [s for s, m in writer.history if "loss" in m] == [3, 4]
    for k, v in straight.params.items():
        assert torch.equal(v, resumed.params[k]), k
    a = Checkpointer(tmp_path / "a" / "ckpt").restore_params(4)
    b = Checkpointer(tmp_path / "b" / "ckpt").restore_params(4)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_preemption_saves_the_step_and_stops(tmp_path, monkeypatch):
    """SIGTERM during step 2: PreemptionHook saves step 2 and stops."""
    from dtf_tpu_torch import loop
    from dtf_tpu_torch.hooks import Hook

    class SigtermAt(Hook):
        def after_step(self, step, state, metrics):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    init = loop.Trainer.__init__

    def with_sigterm(self, *a, **kw):
        init(self, *a, **kw)
        self.hooks.insert(0, SigtermAt())

    monkeypatch.setattr(loop.Trainer, "__init__", with_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    state, _ = _run(tmp_path, 10)
    assert state.step == 2
    assert Checkpointer(tmp_path / "ckpt").latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) == before


def _manifest_keys_of_the_jax_launcher():
    src = open(os.path.join(ROOT, "scripts", "train_gpt.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "manifest_cfg"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("manifest_cfg not found in scripts/train_gpt.py")


def test_manifest_and_generate_from_the_checkpoint(tmp_path):
    state, _ = _run(tmp_path, 3, "--kv_heads=2")
    manifest = load_model_config(tmp_path / "ckpt")
    assert set(manifest) == _manifest_keys_of_the_jax_launcher()
    assert manifest["size"] == "tiny" and manifest["kv_heads"] == 2
    npz = tmp_path / "trained.npz"
    convert.save_npz(str(npz), convert.params_to_flax(
        {k: v.detach() for k, v in state.params.items()}))
    common = ["--device=cpu", "--prompt=5,6,7", "--n_new=6", "--batch=2"]
    rows = {}
    for name, src in (("logdir", [f"--logdir={tmp_path}"]),
                      ("npz", [f"--logdir={tmp_path}",
                               f"--params_npz={npz}"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert generate_gpt.main(common + src) == 0
        rows[name] = buf.getvalue().split()
    assert rows["logdir"] == rows["npz"] and len(rows["logdir"]) == 2


def test_synthetic_batches_equal_the_jax_package():
    for host, count in ((0, 1), (1, 2)):
        j = jsynthetic.SyntheticData("gpt", 4, seed=5, seq_len=24,
                                     vocab_size=97, host_index=host,
                                     host_count=count)
        t = tsynthetic.SyntheticData("gpt", 4, seed=5, seq_len=24,
                                     vocab_size=97, host_index=host,
                                     host_count=count)
        for step in (0, 3):
            want, got = j.batch(step), t.batch(step)
            assert set(want) == set(got)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_token_bin_batches_equal_the_jax_package(tmp_path, host_index,
                                                 host_count):
    rng = np.random.default_rng(0)
    rng.integers(0, 500, 4000).astype(np.uint16).tofile(tmp_path / "train.bin")
    rng.integers(0, 500, 100).astype(np.uint16).tofile(tmp_path / "val.bin")
    kw = dict(mode="clm", vocab_size=500, seed=2, host_index=host_index,
              host_count=host_count)
    j = jformats.detect_token_data(str(tmp_path), 4, 32, **kw)
    t = tformats.detect_token_data(str(tmp_path), 4, 32, **kw)
    for step in (0, 7):
        want, got = j.batch(step), t.batch(step)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # a val split too short for seq_len falls back to None in both
    assert jformats.detect_token_data(str(tmp_path), 4, 128, split="val",
                                      **kw) is None
    assert tformats.detect_token_data(str(tmp_path), 4, 128, split="val",
                                      **kw) is None
    assert tformats.detect_token_data("", 4, 32, **kw) is None
    # BERT's dynamic masking (ported): the same batches as the reference
    kw["mode"] = "mlm"
    j = jformats.TokenBinData(str(tmp_path), 4, 32, **kw)
    t = tformats.TokenBinData(str(tmp_path), 4, 32, **kw)
    want, got = j.batch(2), t.batch(2)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_init_distributions_match_make_init():
    """Leaf by leaf: zeros and ones exactly; std within 3% (>= 65k draws
    a leaf); the lecun-normal truncation bound 2/0.8796 σ reached, not
    passed."""
    kw = dict(vocab_size=512, d_model=256, layers=1, heads=4, d_ff=512)
    _, init_fn = jgpt.make_init(jgpt.GPTConfig(**kw), None, seq_len=8)
    want = convert.params_from_flax(jax.tree.map(
        np.asarray, jax.jit(init_fn)(jax.random.PRNGKey(0))["params"]))
    got = convert.params_from_flax(
        convert.init_params_flax(tgpt.GPTConfig(**kw), seed=0))
    assert set(got) == set(want)
    for k in want:
        w, g = want[k].double(), got[k].double()
        assert g.shape == w.shape, k
        if w.ndim == 1:
            assert torch.equal(g, w), k
            continue
        assert abs(g.std().item() / w.std().item() - 1) < 0.03, k
        if k.endswith("token_embed.weight"):
            continue                        # plain normal: no bound
        bound = 2.0 / 0.87962566103423978 / w.shape[1] ** 0.5
        for x in (w, g):
            m = x.abs().max().item()
            assert 0.97 * bound < m <= bound * (1 + 1e-6), (k, m, bound)


@pytest.mark.parametrize("flag", [
    "--moe_every=2", "--tp_overlap", "--matmul_precision=int8",
    "--mesh_model=2", "--mesh_seq=2", "--mesh_pipe=2", "--mesh_expert=2",
    "--devices_per_host=2", "--pipe_schedule=1f1b",
    "--pipe_microbatches=2", "--distill_from=d", "--stream_spec=x.json",
    "--publish_dir=p", "--event_log_dir=e", "--distill_draft=1",
    "--profile_steps=3", "--telemetry", "--optimizer=lamb",
    "--optimizer=adafactor"])
def test_unported_flags_raise(tmp_path, flag):
    """More than one worker and ``--mesh_data`` are ported (data
    parallelism, ``tests/test_torch_multirank.py``); a data axis > 1 in
    one process is a usage error (``tests/test_torch_dist.py``). lamb and
    adafactor are ported since (``tests/test_torch_optim.py`` holds them
    against optax): those two flags now train a step."""
    if flag.startswith("--optimizer="):
        state, _ = _run(tmp_path, 1, flag)
        assert state.step == 1
        return
    if flag == "--publish_dir=p":   # ported since: the step is published
        state, _ = _run(tmp_path, 1, f"--publish_dir={tmp_path}/p")
        assert read_manifest(f"{tmp_path}/p")["step"] == state.step == 1
        return
    if flag == "--tp_overlap":      # ported since: without a model axis
        state, _ = _run(tmp_path, 1, flag)  # it warns and trains
        assert state.step == 1
        return
    if flag == "--mesh_model=2":    # ported since (tensor parallelism): a
        # model axis > 1 in one process is a usage error
        with pytest.raises(ValueError, match="one process per device"):
            _run(tmp_path, 1, flag)
        return
    if flag == "--event_log_dir=e":  # ported since: the run's events
        _run(tmp_path, 1, f"--event_log_dir={tmp_path}/e")
        from dtf_tpu_torch.telemetry.events import read_events

        assert [e["event"] for e in read_events(f"{tmp_path}/e")] == [
            "ckpt_save", "train_end"]
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _run(tmp_path, 1, flag)


def test_cluster_flags(tmp_path, caplog):
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, 1, "--job_name=ps")
    assert e.value.code == 0
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        state, _ = _run(tmp_path, 1, "--issync=false", "--grad_shard",
                        "--grad_accum=2")
    assert state.step == 1
    assert "issync" in caplog.text and "grad_shard" in caplog.text


def test_resolve_lm_loss_budgets_against_the_card(monkeypatch, caplog):
    """The JAX package's policy against the card's memory (stubbed: the
    test runs without one). Logits + cotangent within 25% of it keep the
    monolithic path; past it, the token-chunked loss at 4096 with a
    warning. Explicit flags win, warning when the logits would fit, and
    for a forced vocab chunk where they do not. On the CPU there is no
    budget."""
    import argparse
    import types

    from dtf_tpu_torch.cli import flags as tflags

    def resolve(batch, seq, device="cuda", **flags):
        args = argparse.Namespace(**{"loss_chunk_vocab": 0,
                                     "loss_chunk_tokens": 0,
                                     "loss_pallas": False, **flags})
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
            path = tflags.resolve_lm_loss(args, batch=batch, seq_len=seq,
                                          vocab_size=50304, device=device)
        return path, caplog.text

    path, warned = resolve(64, 4096, device="cpu")
    assert path[:3] == (0, 0, False) and "no budget" in path.source
    assert not warned
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80e9))
    # GPT-2 small b8 s1024: 2 x 8·1024·50304 x 4 B = 3.3 GB of 80 GB
    path, warned = resolve(8, 1024)
    assert path[:3] == (0, 0, False) and "fit" in path.source
    assert not warned
    # b64 s2048: 52.7 GB > 20 GB
    path, warned = resolve(64, 2048)
    assert path == (0, tflags.AUTO_LOSS_CHUNK_TOKENS, False,
                    "HBM heuristic (no banked winner)")
    assert "auto-selecting the token-chunked" in warned
    path, warned = resolve(8, 1024, loss_pallas=True)
    assert path == (0, 0, True, "explicit")
    assert "--loss_pallas forces a fused LM loss" in warned
    path, warned = resolve(64, 2048, loss_chunk_vocab=8192)
    assert path == (8192, 0, False, "explicit")
    assert "--loss_chunk_vocab forces" in warned
    path, warned = resolve(64, 2048, loss_chunk_tokens=1024)
    assert path == (0, 1024, False, "explicit") and not warned


@pytest.fixture
def empty_tune_cache(tmp_path, monkeypatch):
    """The JAX package's kernel-tune cache with nothing banked (the
    ``tune_env`` pattern of tests/test_tune.py)."""
    from dtf_tpu.tune import resolver

    monkeypatch.setenv("DTF_KERNEL_TUNE_PATH",
                       str(tmp_path / "KERNEL_TUNE.local.json"))
    monkeypatch.setenv("DTF_KERNEL_TUNE_GOLDEN",
                       str(tmp_path / "KERNEL_TUNE.json"))
    resolver.invalidate()
    yield
    resolver.invalidate()


@pytest.mark.parametrize("batch,seq", [(8, 1024), (64, 2048)])
@pytest.mark.parametrize("flags", [
    {}, {"loss_pallas": True}, {"loss_chunk_tokens": 64},
    {"loss_chunk_vocab": 50}], ids=["auto", "pallas", "tokens", "vocab"])
def test_resolve_lm_loss_matches_jax(empty_tune_cache, flags, batch, seq):
    """The same path as ``dtf_tpu.cli.flags.resolve_lm_loss`` with no
    banked winner, at the same memory budget."""
    import argparse

    from dtf_tpu.cli import flags as jflags
    from dtf_tpu_torch.cli import flags as tflags

    args = argparse.Namespace(**{"loss_chunk_vocab": 0,
                                 "loss_chunk_tokens": 0,
                                 "loss_pallas": False, **flags})
    kw = dict(batch=batch, seq_len=seq, vocab_size=50304, hbm_bytes=80e9)
    want = jflags.resolve_lm_loss(args, **kw)
    got = tflags.resolve_lm_loss(args, device="cpu", **kw)
    assert tuple(got[:3]) == tuple(want[:3])
    if want.source.startswith("monolithic logits fit"):
        assert got.source.startswith("monolithic logits fit")
    else:
        assert got.source == want.source


@pytest.mark.parametrize("flag", ["--loss_pallas", "--loss_chunk_tokens=64",
                                  "--loss_chunk_vocab=50"])
def test_fused_loss_flags_train_like_the_monolithic_loss(tmp_path, flag):
    """Two steps through each fused loss end in ``done: step=2`` with the
    monolithic run's losses and parameters (f32 on the CPU, 1e-5)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_gpt.main(TINY + [f"--logdir={tmp_path / 'f'}",
                                      "--train_steps=2", flag]) == 0
    assert buf.getvalue().strip().splitlines()[-1] == "done: step=2"
    fused = Checkpointer(tmp_path / "f" / "ckpt").restore_params(2)
    _, fused_w = _run(tmp_path / "f2", 2, flag)
    _, mono_w = _run(tmp_path / "m", 2)
    mono = Checkpointer(tmp_path / "m" / "ckpt").restore_params(2)

    def losses(writer):
        return [m["loss"] for _, m in writer.history if "loss" in m]

    np.testing.assert_allclose(losses(fused_w), losses(mono_w), atol=1e-5,
                               rtol=0)
    for k in mono:
        np.testing.assert_allclose(fused[k].numpy(), mono[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_fused_loss_flags_are_mutually_exclusive(tmp_path):
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, 1, "--loss_pallas", "--loss_chunk_tokens=64")
    assert e.value.code == 2
