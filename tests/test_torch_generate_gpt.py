"""The port's generate entry (``python -m dtf_tpu_torch.generate_gpt``) and
its manifest merge, in process on the CPU, against the JAX launcher's
rules (``dtf_tpu.cli.flags.resolve_decode_config``)."""

import json
import types

import numpy as np
import pytest
import torch

from dtf_tpu.cli import flags as jflags
from dtf_tpu_torch import convert, generate_gpt
from dtf_tpu_torch.cli import flags as tflags
from dtf_tpu_torch.models import gpt as tgpt


def _rows(capsys):
    return [r for r in capsys.readouterr().out.splitlines() if r.strip()]


def test_cli_rows_equal_direct_generate(tmp_path, capsys):
    cfg = tgpt.GPTConfig.tiny(kv_heads=2, decode_len=9)
    tree = convert.init_params(cfg, seed=5)
    path = str(tmp_path / "p.npz")
    convert.save_npz(path, tree)
    rc = generate_gpt.main(["--size=tiny", f"--params_npz={path}",
                            "--device=cpu", "--kv_heads=2", "--batch=2",
                            "--prompt=9,8,7", "--n_new=6"])
    assert rc == 0
    rows = _rows(capsys)
    model = tgpt.GPT(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    want = tgpt.generate(model.eval(), torch.tensor([[9, 8, 7]] * 2), 6)
    assert rows == [",".join(map(str, r)) for r in want.tolist()]


def test_cli_sampling_repeats_per_seed(capsys):
    argv = ["--size=tiny", "--init_seed=0", "--device=cpu", "--n_new=8",
            "--temperature=0.9", "--top_k=30", "--seed=3"]
    generate_gpt.main(argv)
    first = _rows(capsys)
    generate_gpt.main(argv)
    assert _rows(capsys) == first


@pytest.mark.parametrize("argv,error,match", [
    # sharded decode is ported since (tests/test_torch_tp_serve.py): a
    # model axis > 1 in one process is a usage error
    (["--mesh_model=2"], ValueError, "one process per device"),
], ids=["mesh"])
def test_cli_not_yet_ported_raises(argv, error, match):
    with pytest.raises(error, match=match):
        generate_gpt.main(["--size=tiny", "--init_seed=0", "--device=cpu",
                           *argv])


_TINY = ["--size=tiny", "--device=cpu", "--init_seed=0"]


@pytest.mark.parametrize("argv", [
    _TINY + ["--top_k=5"],                           # greedy + top_k
    _TINY + ["--num_beams=2", "--temperature=0.5"],
    _TINY + ["--prompt=1,999"],                      # out of the vocab
    ["--size=tiny", "--device=cpu"],                 # no parameters
    ["--size=huge", "--device=cpu", "--init_seed=0"],
])
def test_cli_usage_errors(argv):
    with pytest.raises(SystemExit) as e:
        generate_gpt.main(argv)
    assert e.value.code == 2


class _AbslLike:
    """The attribute + ``FLAGS[name].present`` surface the JAX launcher's
    resolver reads, built from the same values."""

    def __init__(self, values, present):
        self.__dict__.update(values)
        self._present = present

    def __getitem__(self, name):
        return types.SimpleNamespace(present=name in self._present)


_DEFAULTS = {"size": "small", "kv_heads": 0, "attn_window": 0,
             "attn_global_every": 0, "kv_cache_dtype": ""}


@pytest.mark.parametrize("given,manifest", [
    ({}, None),
    ({"size": "tiny", "kv_heads": 2}, None),
    ({}, {"size": "tiny", "kv_heads": 2, "attn_window": 8}),
    ({"size": "tiny"}, {"size": "tiny", "kv_cache_dtype": "int8"}),
    ({"kv_cache_dtype": ""}, {"size": "tiny", "kv_cache_dtype": "int8"}),
    ({"size": "medium"}, {"size": "tiny"}),                 # contradicts
    ({}, {"size": "tiny", "moe_every": 2}),                 # MoE checkpoint
    ({"kv_cache_dtype": "int8"}, {"d_model": 30, "heads": 2}),  # odd d_head
    ({"kv_cache_dtype": "fp8"}, None),
])
def test_resolve_decode_config_matches_jax(given, manifest):
    values = {**_DEFAULTS, **given}
    args = types.SimpleNamespace(**values)

    def run(fn, *a):
        try:
            return fn(*a)
        except ValueError as e:
            return ("ValueError", str(e).split(";")[0].split(" must")[0])

    want = run(jflags.resolve_decode_config, _AbslLike(values, set(given)),
               manifest)
    got = run(tflags.resolve_decode_config, args, manifest,
              frozenset(given))
    if isinstance(want, tuple):
        assert isinstance(got, tuple), got
        assert got[1].split("=")[0] == want[1].split("=")[0]
    else:
        assert got == want


def test_manifest_in_logdir_sets_the_architecture(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model_config.json").write_text(json.dumps(
        {"size": "tiny", "kv_heads": 2, "attn_window": 0,
         "attn_global_every": 0}))
    argv = [f"--logdir={tmp_path}", "--init_seed=0", "--device=cpu",
            "--n_new=3"]
    assert generate_gpt.main(argv) == 0
    rows = _rows(capsys)
    assert len(rows) == 1 and len(rows[0].split(",")) == 7
    with pytest.raises(SystemExit):
        generate_gpt.main(argv + ["--kv_heads=4"])       # contradicts


def test_present_flags():
    assert generate_gpt._present(["--size=tiny", "--seed", "3"]) == {
        "size", "seed"}
    assert generate_gpt._present([]) == frozenset()
    np.testing.assert_equal(sorted(generate_gpt._present(["--issync"])),
                            ["issync"])
