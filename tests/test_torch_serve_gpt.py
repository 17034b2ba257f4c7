"""The port's serving launcher (``python -m dtf_tpu_torch.serve_gpt``), in
process on the CPU: its rows equal the engine's, a ``train_gpt`` logdir
serves, the Poisson mode reports the reference's keys, a fleet
(``--replicas``, ``--prefill_replicas``, a ``DTF_FAULT_INJECT`` wedge)
serves the same rows and reports the reference's fleet keys, and every
flag of a feature not yet ported raises."""

import json

import pytest
import torch

from dtf_tpu_torch import convert, serve_gpt, train_gpt
from dtf_tpu_torch.checkpoint import Checkpointer
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import DecodeEngine, ServeClient

_TINY = ["--size=tiny", "--device=cpu", "--init_seed=0"]
#: the keys of the reference launcher's line for what the port does
_KEYS = ("mode", "backend", "step", "served_version", "final_version",
         "replicas", "request_statuses", "n_slots", "max_len",
         "prefill_chunk", "requests", "generated_tokens", "wall_s",
         "tokens_per_sec", "cache_mib", "serve_completed",
         "serve_ttft_p50_s", "serve_ttft_p99_s", "serve_tok_latency_p50_s",
         "serve_tok_latency_p99_s", "serve_occupancy_mean",
         "serve_queue_peak", "serve_decode_steps", "serve_prefill_chunks")


def _lines(capsys):
    return [r for r in capsys.readouterr().out.splitlines() if r.strip()]


def _engine_rows(state_dict, cfg, prompts, n_new, **eng_kw):
    eng = DecodeEngine(cfg, state_dict, device="cpu", **eng_kw)
    client = ServeClient(eng)
    rids = [client.submit(p, max_new=n_new, seed=i)
            for i, p in enumerate(prompts)]
    client.drain()
    return [f"{rid}:" + ",".join(map(str, client.result(rid)))
            for rid in rids]


def test_requests_rows_equal_the_engine(capsys):
    rc = serve_gpt.main(_TINY + ["--requests=12,7,99;5,6,7,8;3",
                                 "--n_new=6", "--emit_tokens",
                                 "--n_slots=2", "--max_len=32",
                                 "--prefill_chunk=4"])
    assert rc == 0
    lines = _lines(capsys)
    out = json.loads(lines[-1])
    cfg = tgpt.GPTConfig.tiny()
    want = _engine_rows(convert.params_from_flax(convert.init_params(cfg, 0)),
                        cfg, [[12, 7, 99], [5, 6, 7, 8], [3]], 6, n_slots=2,
                        max_len=32, prefill_chunk=4)
    assert lines[:-1] == want
    assert all(k in out for k in _KEYS), sorted(out)
    assert out["request_statuses"] == {"done": 3}
    assert out["generated_tokens"] == 18 and out["device"] == "cpu"


def test_a_train_gpt_logdir_serves(tmp_path, capsys):
    logdir = str(tmp_path / "run")
    train_gpt.run(["--device=cpu", "--size=tiny", "--batch_size=2",
                   "--seq_len=16", "--train_steps=2", f"--logdir={logdir}",
                   "--log_every=1"])
    capsys.readouterr()
    out, rows, engine = serve_gpt.run(
        [f"--logdir={logdir}", "--device=cpu", "--requests=4,5,6;9",
         "--n_new=5", "--emit_tokens", "--max_len=32"])
    assert out["step"] == 2 and out["request_statuses"] == {"done": 2}
    params = Checkpointer(f"{logdir}/ckpt").restore_params()
    assert rows == _engine_rows(params, engine.cfg, [[4, 5, 6], [9]], 5,
                                n_slots=8, max_len=32, prefill_chunk=16)
    with pytest.raises(SystemExit):         # contradicts the manifest
        serve_gpt.run([f"--logdir={logdir}", "--device=cpu", "--size=small",
                       "--requests=1"])


def test_poisson_mode(monkeypatch, capsys):
    """The launcher's scheduler and its replay pump run on a clock that
    only the replay's waits advance, so the 10-s TTFT objective is held
    against the arrivals, not a loaded host's wall clock."""
    import functools

    from dtf_tpu_torch import serve

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, s):
            self.t += max(s, 0.0)

    clock = Clock()
    monkeypatch.setattr(serve, "Scheduler", functools.partial(
        serve.Scheduler, clock=clock))
    monkeypatch.setattr(serve, "replay", functools.partial(
        serve.replay, clock=clock, sleep=clock.sleep))
    out, rows, _ = serve_gpt.run(
        _TINY + ["--poisson_rate=1000", "--n_requests=5", "--max_len=40",
                 "--prompt_min=3", "--prompt_max=20", "--new_min=2",
                 "--new_max=6", "--n_slots=2", "--prefill_chunk=4",
                 "--ttft_slo=10", "--stats_every=3", "--temperature=0.8",
                 "--top_p=0.9"])
    assert rows == [] and out["mode"] == "poisson"
    assert out["request_statuses"] == {"done": 5}
    assert out["serve_ttft_slo_ok_frac"] == 1.0 and out["heartbeats"] >= 1


#: the fleet keys of the reference launcher's line
_FLEET_KEYS = ("replicas", "prefill_replicas", "fault_inject",
               "router_replicas", "router_completed", "router_requeued",
               "router_quarantines", "router_ttft_p50_s", "router_ticks",
               "replica0_health", "replica1_health",
               "replica0_serve_completed", "replica1_serve_requeued_in",
               "cp_pick_total_s", "cp_engine_tick_mean_s",
               "cp_health_sweep_p99_s", "cp_page_ops_total_s",
               "cp_bookkeeping_total_s")
_FLEET_REQUESTS = ["--requests=12,7,99;5,6,7,8;3;9,9,9,9,9,9,9,9,9,1",
                   "--n_new=6", "--emit_tokens", "--n_slots=2",
                   "--max_len=32", "--prefill_chunk=4"]


def _single_rows():
    out, rows, _ = serve_gpt.run(_TINY + _FLEET_REQUESTS)
    return rows


def test_fleet_serves_the_engines_rows(capsys):
    """Two replicas behind the router: the rows of one engine, the
    reference's fleet keys, one set of weights, the heartbeat's router
    panel."""
    out, rows, router = serve_gpt.run(_TINY + _FLEET_REQUESTS
                                      + ["--replicas=2", "--stats_every=2"])
    assert rows == _single_rows()
    # a fleet's line has the router's keys where one scheduler's has serve_*
    assert all(k in out for k in _FLEET_KEYS + tuple(
        k for k in _KEYS if not k.startswith("serve_"))), sorted(out)
    assert out["replicas"] == 2 and out["fault_inject"] == ""
    assert out["request_statuses"] == {"done": 4}
    assert {router.replica_of(r) for r in range(4)} == {0, 1}
    a, b = (s.engine._model for s in router.schedulers)
    assert a.lm_head.weight.data_ptr() == b.lm_head.weight.data_ptr()
    assert out["heartbeats"] >= 1
    assert '"router_completed"' in capsys.readouterr().err


def test_fleet_disaggregated(capsys):
    out, rows, router = serve_gpt.run(
        _TINY + _FLEET_REQUESTS + ["--replicas=2", "--prefill_replicas=1",
                                   "--prefix_pages=8", "--kv_page_size=4"])
    assert rows == _single_rows()
    assert out["prefill_replicas"] == 1 and out["router_handoffs"] > 0
    assert out["replica0_role"] == "prefill"
    assert out["router_pages_loaded"] > 0
    assert router.schedulers[1].engine.prefix_stats()["pinned"] == 0


def test_fleet_wedge_plan_quarantines_and_requeues(monkeypatch, capsys):
    """``DTF_FAULT_INJECT=wedge_replica@2:replica=0``: replica 0's third
    decode sleeps past ``--health_wedge_s``, the watchdog quarantines it,
    its requests finish on replica 1 with the same tokens. The launcher's
    router runs on a clock that only the wedge's sleep advances (through
    the ``Router`` and ``install_serve_fault`` it imports), so a loaded
    host's slow ticks cannot move the verdict."""
    import functools

    from dtf_tpu_torch import serve
    from dtf_tpu_torch.serve import health

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def advance(self, s):
            self.t += s

    clock = Clock()

    plain = serve.Router

    class ClockedRouter(plain):
        @classmethod
        def build(cls, *args, **kw):
            return plain.build.__func__(cls, *args, clock=clock, **kw)

    monkeypatch.setattr(serve, "Router", ClockedRouter)
    monkeypatch.setattr(serve, "install_serve_fault", functools.partial(
        health.install_serve_fault, sleep=clock.advance))
    monkeypatch.setenv("DTF_FAULT_INJECT", "wedge_replica@2:replica=0")
    monkeypatch.setenv("DTF_FAULT_WEDGE_S", "1.2")
    out, rows, _ = serve_gpt.run(
        _TINY + _FLEET_REQUESTS + ["--replicas=2", "--health_slow_s=0.5",
                                   "--health_wedge_s=1.0",
                                   "--health_probation_s=600"])
    assert out["fault_inject"] == "wedge_replica@2:replica=0"
    assert out["router_quarantines"] == 1.0
    assert out["replica0_health"] == "quarantined"
    assert out["replica1_serve_requeued_in"] > 0
    assert out["request_statuses"] == {"done": 4}
    assert clock.t == 1.2
    monkeypatch.delenv("DTF_FAULT_INJECT")
    assert rows == _single_rows()


@pytest.mark.parametrize("flag", [
    "--draft_ckpt=/x", "--draft_layers=1", "--draft_precision=int8",
    "--publish_dir=/x",
    "--publish_version=3", "--swap_poll_ticks=2", "--draft_publish_dir=/x",
    "--telemetry", "--trace_out=/x.json", "--log_sink_dir=/x",
    "--event_log_dir=/x", "--mesh_model=2", "--mesh_data=2"])
def test_unported_flags_raise(flag, tmp_path):
    """The publish flags are ported since: here (no publish dir, or one
    that does not exist) they fail the reference's usage checks
    (tests/test_torch_serve_swap.py serves and rolls them). The run-record
    plane's flags are ported since too: here each serves with its output
    under a temporary directory (tests/test_torch_events.py,
    test_torch_servelog.py and test_torch_serve_trace.py hold them against
    the JAX package's)."""
    if flag.split("=")[0] in ("--publish_dir", "--publish_version",
                              "--swap_poll_ticks"):
        with pytest.raises(SystemExit):
            serve_gpt.run(_TINY[:-1] + ["--requests=1,2", flag])
        return
    name = flag.split("=")[0]
    if name in ("--telemetry", "--trace_out", "--log_sink_dir",
                "--event_log_dir"):
        arg = name if name == "--telemetry" else f"{name}={tmp_path}/x"
        out, _, _ = serve_gpt.run(_TINY + ["--requests=1,2", arg,
                                           f"--logdir={tmp_path}"])
        assert out["request_statuses"] == {"done": 1}
        key = {"--telemetry": "trace_counts", "--trace_out": "trace_events",
               "--log_sink_dir": "log_sink", "--event_log_dir": "event_log"}
        assert key[name] in out
        return
    if name in ("--mesh_model", "--mesh_data"):
        # sharded serving is ported since (tests/test_torch_tp_serve.py):
        # a mesh axis > 1 in one process is a usage error
        with pytest.raises(ValueError, match="one process per device"):
            serve_gpt.run(_TINY + ["--requests=1,2", flag])
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve_gpt.run(_TINY + ["--requests=1,2", flag])


@pytest.mark.parametrize("argv", [
    ["--requests=1,2", "--n_slots=0"],
    ["--requests=1,2", "--prefill_chunk=1"],
    ["--requests=1,999"],
    ["--max_len=8", "--new_min=8"],
    ["--requests=1,2", "--spec_k=2"],
    ["--requests=1,2", "--prefix_pages=4"],
    ["--requests=1,2", "--kv_page_size=8"],
    ["--requests=1,2", "--replicas=0"],
    ["--requests=1,2", "--replicas=2", "--prefill_replicas=1"],
    ["--requests=1,2", "--replicas=2", "--prefill_replicas=2",
     "--prefix_pages=8", "--kv_page_size=4"],
    ["--requests=1,2", "--replicas=2", "--health_wedge_s=1"],
], ids=["slots", "chunk", "token_range", "no_room", "spec_without_draft",
        "pages_without_size", "size_without_pages", "no_replica",
        "prefill_without_pages", "no_decode_replica", "wedge_under_slow"])
def test_usage_errors(argv):
    with pytest.raises(SystemExit):
        serve_gpt.run(_TINY + argv)


def test_cuda_by_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_gpt.run(["--size=tiny", "--init_seed=0", "--requests=1"])
