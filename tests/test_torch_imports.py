"""The port stands alone: no jax, flax or dtf_tpu anywhere in it.

Dynamic: a child process whose ``jax``, ``jaxlib``, ``flax`` and
``dtf_tpu`` imports are POISONED imports every module of the port and runs
its generate and train entries (the latter also through the fused LM
loss), the serving launcher (also sharded over two gloo ranks), the
Wide&Deep trainer and the MNIST ``distributed`` launcher on
``--device=cpu`` at a tiny size.
Static: no file
of ``dtf_tpu_torch/``, and not ``chip_smoke.py``, has an import of them.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "absl", "dtf_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dtf_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _port_modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_no_forbidden_import_in_the_port():
    found = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    found.append(f"{os.path.relpath(path, ROOT)}:"
                                 f"{node.lineno} imports {name}")
    assert not found, found
    assert len(_port_files()) > 10


@pytest.fixture
def poisoned_env(tmp_path, cpu_sim_subprocess_env):
    poison = tmp_path / "poison"
    for mod in ("jax", "jaxlib", "flax", "dtf_tpu"):
        d = poison / mod
        d.mkdir(parents=True)
        (d / "__init__.py").write_text(
            f"raise ImportError('{mod} is poisoned: the port must not "
            "import it')\n")
    env = dict(cpu_sim_subprocess_env)
    env["PYTHONPATH"] = f"{poison}{os.pathsep}{ROOT}"
    # the child runs from outside the repository: the working directory
    # comes first on sys.path and would shadow the poison
    return env, str(tmp_path)


def test_port_imports_and_generates_with_jax_poisoned(poisoned_env):
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "try:\n"
        "    import dtf_tpu\n"
        "    raise SystemExit('poison did not take')\n"
        "except ImportError:\n"
        "    pass\n"
        "from dtf_tpu_torch import generate_gpt\n"
        "rc = generate_gpt.main(['--size=tiny', '--init_seed=0',\n"
        "                        '--device=cpu', '--n_new=4', '--batch=2',\n"
        "                        '--kv_cache_dtype=int8'])\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dtf_tpu')]\n"
        "assert not bad, bad\n"
        "print('POISON_OK', rc)\n")
    env, cwd = poisoned_env
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "POISON_OK 0"
    rows = lines[:-1]
    assert len(rows) == 2 and rows[0] == rows[1]
    assert rows[0].startswith("1,2,3,4,") and len(rows[0].split(",")) == 8


def test_train_entry_as_a_module_with_jax_poisoned(poisoned_env, tmp_path):
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.train_gpt", "--device=cpu",
         "--size=tiny", "--train_steps=2", "--batch_size=2", "--seq_len=16",
         f"--logdir={tmp_path / 'run'}"], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "done: step=2"


def test_fused_loss_train_entry_with_jax_poisoned(poisoned_env, tmp_path):
    """``train_gpt --loss_pallas`` (the fused head + CE, ``ops/fused_ce``)
    runs on the CPU with nothing of JAX importable."""
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.train_gpt", "--device=cpu",
         "--size=tiny", "--train_steps=2", "--batch_size=2", "--seq_len=16",
         "--loss_pallas", f"--logdir={tmp_path / 'run'}"], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "done: step=2"


def test_widedeep_train_entry_as_a_module_with_jax_poisoned(poisoned_env,
                                                            tmp_path):
    """``train_widedeep`` (the row-sharded embedding layer, B8's module
    and the Criteo/synthetic loaders) runs with nothing of JAX
    importable."""
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.train_widedeep",
         "--device=cpu", "--hash_buckets=500", "--batch_size=64",
         "--train_steps=2", f"--logdir={tmp_path / 'run'}"], env=env,
        cwd=cwd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "done: step=2"


def test_generate_entry_as_a_module_with_jax_poisoned(poisoned_env):
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.generate_gpt", "--size=tiny",
         "--init_seed=1", "--backend=cpu", "--n_new=3",
         "--prompt=5,6,7"], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = proc.stdout.strip().splitlines()[-1].split(",")
    assert row[:3] == ["5", "6", "7"] and len(row) == 6


def test_distributed_entry_as_a_module_with_jax_poisoned(poisoned_env,
                                                         tmp_path):
    """``python -m dtf_tpu_torch.distributed`` (MNIST: the cluster flags,
    the launcher, the mesh and collectives' modules, the train step) runs
    with nothing of JAX importable."""
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.distributed", "--backend=cpu",
         "--train_steps=3", "--model=mlp", f"--logdir={tmp_path / 'run'}"],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith(
        "done: step=3 eval_accuracy=")


def test_serve_entry_as_a_module_with_jax_poisoned(poisoned_env):
    """``python -m dtf_tpu_torch.serve_gpt`` (the serving engine, its
    scheduler and client) serves on the CPU with nothing of JAX
    importable."""
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.serve_gpt", "--size=tiny",
         "--init_seed=0", "--device=cpu", "--requests=12,7,99;5,6,7,8",
         "--n_new=4", "--emit_tokens", "--kv_cache_dtype=int8"], env=env,
        cwd=cwd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert [r.split(":")[0] for r in lines[:-1]] == ["0", "1"]
    assert '"request_statuses": {"done": 2}' in lines[-1]


def test_speculative_paged_serving_with_jax_poisoned(poisoned_env):
    """``serve_gpt`` with speculative decoding (an early-exit draft) and
    the prefix page pool (``serve/pages``, the verify and page steps)
    serves on the CPU with nothing of JAX importable."""
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.serve_gpt", "--size=tiny",
         "--init_seed=0", "--device=cpu", "--n_new=6", "--spec_k=2",
         "--draft_layers=1", "--prefix_pages=8", "--kv_page_size=4",
         "--requests=1,2,3,4,5,6,7,8,9;1,2,3,4,5,6,7,8,10"], env=env,
        cwd=cwd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert '"request_statuses": {"done": 2}' in out
    assert '"spec_k": 2' in out and '"serve_prefix_pinned": 0.0' in out


def test_fleet_modules_are_in_the_poisoned_import():
    """The router, health, fault-plan and span modules are among the
    modules the poisoned child imports."""
    mods = _port_modules()
    for mod in ("dtf_tpu_torch.serve.router", "dtf_tpu_torch.serve.health",
                "dtf_tpu_torch.fault.inject",
                "dtf_tpu_torch.telemetry.spans"):
        assert mod in mods, mod


def test_beam_search_and_a_faulted_fleet_with_jax_poisoned(poisoned_env):
    """``generate_gpt --num_beams`` and a disaggregated ``serve_gpt
    --replicas 2`` with a ``DTF_FAULT_INJECT`` slow-decode plan run on the
    CPU with nothing of JAX importable."""
    env, cwd = poisoned_env
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.generate_gpt", "--size=tiny",
         "--init_seed=0", "--device=cpu", "--n_new=4", "--num_beams=3",
         "--kv_cache_dtype=int8"], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(proc.stdout.strip().splitlines()[-1].split(",")) == 8
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.serve_gpt", "--size=tiny",
         "--init_seed=0", "--device=cpu", "--n_new=4", "--replicas=2",
         "--n_slots=2", "--prefix_pages=8", "--kv_page_size=4",
         "--prefill_replicas=1", "--requests=1,2,3,4,5,6,7,8,9;5,6,7"],
        env={**env, "DTF_FAULT_INJECT": "slow_decode@1:replica=1",
             "DTF_FAULT_SLOW_S": "0.01"},
        cwd=cwd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert '"request_statuses": {"done": 2}' in out
    assert '"fault_inject": "slow_decode@1:replica=1"' in out


def test_publish_and_rolling_swap_with_jax_poisoned(poisoned_env, tmp_path):
    """``train_gpt --publish_dir`` (``publish``, ``hooks.PublishHook`` and
    the training verbs of ``fault.inject``, armed with a plan for another
    host) publishes, and ``serve_gpt --publish_dir --swap_poll_ticks``
    rolls the fleet from version 1 to 2, with nothing of JAX
    importable."""
    mods = _port_modules()
    for mod in ("dtf_tpu_torch.publish", "dtf_tpu_torch.fault.inject"):
        assert mod in mods, mod
    env, cwd = poisoned_env
    pub = str(tmp_path / "pub")
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.train_gpt", "--device=cpu",
         "--size=tiny", "--train_steps=4", "--batch_size=2", "--seq_len=16",
         f"--logdir={tmp_path / 'run'}", f"--publish_dir={pub}",
         "--publish_every=2"],
        env={**env, "DTF_FAULT_INJECT": "crash@1:host=3"}, cwd=cwd,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.serve_gpt", "--device=cpu",
         f"--publish_dir={pub}", "--publish_version=1", "--replicas=2",
         "--swap_poll_ticks=2", "--canary_ticks=1", "--n_slots=2",
         "--n_new=6", "--requests=1,2,3;4,5;6,7,8,9"], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert '"request_statuses": {"done": 3}' in out
    assert '"served_version": 1, "final_version": 2' in out


def test_record_plane_with_jax_poisoned(poisoned_env, tmp_path):
    """The run-record plane's modules are among those the poisoned child
    imports, and ``train_gpt --event_log_dir`` then ``serve_gpt
    --event_log_dir --log_sink_dir --trace_out --telemetry`` run with
    nothing of JAX importable."""
    mods = _port_modules()
    for mod in ("_hostio", "data.tfrecord", "data.stream.servelog",
                "telemetry.trace", "telemetry.events", "telemetry.profile",
                "telemetry.flight", "telemetry.run", "serve.logsink"):
        assert f"dtf_tpu_torch.{mod}" in mods, mod
    env, cwd = poisoned_env
    ev, pub = str(tmp_path / "events"), str(tmp_path / "pub")
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.train_gpt", "--device=cpu",
         "--size=tiny", "--train_steps=2", "--batch_size=2", "--seq_len=16",
         f"--logdir={tmp_path / 'run'}", f"--publish_dir={pub}",
         "--publish_every=2", f"--event_log_dir={ev}"], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.serve_gpt", "--device=cpu",
         f"--publish_dir={pub}", "--replicas=2", "--n_slots=2", "--n_new=4",
         "--requests=1,2,3;4,5", f"--event_log_dir={ev}",
         f"--log_sink_dir={tmp_path / 'sink'}", "--telemetry",
         f"--trace_out={tmp_path / 'trace.json'}",
         f"--logdir={tmp_path / 'serve'}"], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["request_statuses"] == {"done": 2}
    assert out["log_sink"]["records"] == 2 and out["trace_events"] > 0
    assert out["event_log"]["adopted_shards"] == 0
    from dtf_tpu_torch.telemetry.events import read_events

    kinds = [e["event"] for e in read_events(ev)]
    assert kinds[:4] == ["publish_version", "ckpt_save", "train_end",
                         "serve_start"]
    assert kinds[-1] == "serve_summary"


def test_tensor_parallel_train_entry_with_jax_poisoned(poisoned_env,
                                                       tmp_path):
    """The TP modules (``ops.collective_matmul`` and ``core.comms``' TP
    operators) are among those the poisoned child imports, and two
    ``train_gpt --mesh_model 2 --tp_overlap`` processes over gloo train
    with nothing of JAX importable."""
    assert "dtf_tpu_torch.ops.collective_matmul" in _port_modules()
    from dtf_tpu_torch.core.dist import free_port

    env, cwd = poisoned_env
    env = {**env, "OMP_NUM_THREADS": "1"}
    hosts = f"localhost:{free_port()},localhost:{free_port()}"
    procs = []
    for r in range(2):
        with open(tmp_path / f"{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dtf_tpu_torch.train_gpt",
                 "--backend=cpu", f"--worker_hosts={hosts}",
                 f"--task_index={r}", "--mesh_model=2", "--tp_overlap",
                 "--size=tiny", "--train_steps=2", "--batch_size=2",
                 "--seq_len=16", f"--logdir={tmp_path / 'run'}"],
                env=env, cwd=cwd, stdout=out, stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(tmp_path / f"{r}.log").read_text() for r in range(2)]
    assert rcs == [0, 0], "\n----\n".join(log[-3000:] for log in logs)
    assert logs[0].strip().splitlines()[-1] == "done: step=2"


def test_sharded_serving_entries_with_jax_poisoned(poisoned_env, tmp_path):
    """The sharded serving plane (``serve.plane``) is among the modules
    the poisoned child imports, and two ``serve_gpt --mesh_model 2``
    processes over gloo (the launcher's own group) serve with nothing of
    JAX importable: rank 0 leads and prints the rows and the line, rank
    1 follows and exits 0."""
    assert "dtf_tpu_torch.serve.plane" in _port_modules()
    from dtf_tpu_torch.core.dist import free_port

    env, cwd = poisoned_env
    env = {**env, "OMP_NUM_THREADS": "1"}
    hosts = f"localhost:{free_port()},localhost:{free_port()}"
    procs = []
    for r in range(2):
        with open(tmp_path / f"{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dtf_tpu_torch.serve_gpt",
                 "--backend=cpu", f"--worker_hosts={hosts}",
                 f"--task_index={r}", "--mesh_model=2", "--size=tiny",
                 "--init_seed=0", "--n_slots=2", "--n_new=4",
                 "--requests=1,2,3;4,5", "--emit_tokens"],
                env=env, cwd=cwd, stdout=out, stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(tmp_path / f"{r}.log").read_text() for r in range(2)]
    assert rcs == [0, 0], "\n----\n".join(log[-3000:] for log in logs)
    lines = logs[0].strip().splitlines()
    assert json.loads(lines[-1])["request_statuses"] == {"done": 2}
    assert [row.split(":")[0] for row in lines[-3:-1]] == ["0", "1"]
    assert '"request_statuses"' not in logs[1]


def test_sharded_fleet_entries_with_jax_poisoned(poisoned_env):
    """The sharded fleet's entries — ``Router.build(mesh=)``, the roll's
    ``VersionSource`` and the plane's shard sets — import with nothing of
    JAX importable, and ``serve_gpt --replicas 2 --mesh_model 2`` runs up
    to the launcher's process-group check
    (one process asked for a mesh: the check refuses it)."""
    code = (
        "import inspect, sys\n"
        "from dtf_tpu_torch.serve import Router\n"
        "from dtf_tpu_torch.serve.plane import ShardSets\n"
        "from dtf_tpu_torch.serve.router import VersionSource\n"
        "assert 'mesh' in inspect.signature(Router.build).parameters\n"
        "from dtf_tpu_torch import serve_gpt\n"
        "try:\n"
        "    serve_gpt.run(['--device=cpu', '--size=tiny', '--init_seed=0',\n"
        "                   '--requests=1,2', '--replicas=2',\n"
        "                   '--mesh_model=2', '--canary_ticks=1'])\n"
        "    raise SystemExit('no process-group check')\n"
        "except ValueError as e:\n"
        "    assert 'one process per device' in str(e), e\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dtf_tpu')]\n"
        "assert not bad, bad\n"
        "print('FLEET_OK')\n")
    env, cwd = poisoned_env
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "FLEET_OK"
