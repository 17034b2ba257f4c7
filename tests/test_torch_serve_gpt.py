"""The port's serving launcher (``python -m dtf_tpu_torch.serve_gpt``), in
process on the CPU: its rows equal the engine's, a ``train_gpt`` logdir
serves, the Poisson mode reports the reference's keys, and every flag of
a feature not yet ported raises."""

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


def test_poisson_mode(capsys):
    out, rows, _ = serve_gpt.run(
        _TINY + ["--poisson_rate=1000", "--n_requests=5", "--max_len=40",
                 "--prompt_min=3", "--prompt_max=20", "--new_min=2",
                 "--new_max=6", "--n_slots=2", "--prefill_chunk=4",
                 "--ttft_slo=10", "--stats_every=3", "--temperature=0.8",
                 "--top_p=0.9"])
    assert rows == [] and out["mode"] == "poisson"
    assert out["request_statuses"] == {"done": 5}
    assert out["serve_ttft_slo_ok_frac"] == 1.0 and out["heartbeats"] >= 1


@pytest.mark.parametrize("flag", [
    "--replicas=2", "--prefill_replicas=1",
    "--draft_ckpt=/x", "--draft_layers=1", "--draft_precision=int8",
    "--publish_dir=/x",
    "--publish_version=3", "--swap_poll_ticks=2", "--draft_publish_dir=/x",
    "--telemetry", "--trace_out=/x.json", "--log_sink_dir=/x",
    "--event_log_dir=/x", "--mesh_model=2", "--mesh_data=2"])
def test_unported_flags_raise(flag):
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
], ids=["slots", "chunk", "token_range", "no_room", "spec_without_draft",
        "pages_without_size", "size_without_pages"])
def test_usage_errors(argv):
    with pytest.raises(SystemExit):
        serve_gpt.run(_TINY + argv)


def test_cuda_by_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_gpt.run(["--size=tiny", "--init_seed=0", "--requests=1"])
