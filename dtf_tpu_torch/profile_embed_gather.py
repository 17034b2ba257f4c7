"""B8 with and without programmatic dependent launch (PDL), timed.

    python -m dtf_tpu_torch.profile_embed_gather

Builds ``ops/csrc/embed_gather.cu`` twice into
``build/dtf_tpu_torch/ablate_embed/`` (both ``nvcc`` at once): as the
package builds it (a plain launch), and with ``-DDTF_EMBED_PDL=1``
(``cudaLaunchKernelEx`` with programmatic stream serialization, and
``griddepcontrol.wait`` before the kernel's first read). Each is timed at
the lookup of one rank of ``train_widedeep --mesh_model 2``: shard 1 of 2
(wide [1.3M, 1] f32, deep [1.3M, 16] f32 into bf16 rows), the ids of 128
synthetic batches of 512 x 26, one call per batch in a CUDA graph, so the
rows arrive cold. Device ms of one call:

- ``path``: the ids' add (bucket ids + the features' offsets, as
  ``WideDeep.flat_ids``) then B8, as the forward runs them, less the add
  alone (``ids``);
- ``after_b8``: B8 after B8 on ids computed beforehand.

The variants run base, pdl, pdl, base, and each checks its outputs
against ``masked_gather_rows_reference``. Prints one JSON line with the
card's name and power limit. Needs a GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

#: train_widedeep's defaults: batch, features, buckets a feature, deep width
BATCH, SPARSE, BUCKETS, EMBED = 512, 26, 100_000, 16
VARIANTS = {"base": (), "pdl": ("-DDTF_EMBED_PDL=1",)}


def graph_ms(torch, calls) -> float:
    """Mean device ms of one call of ``calls``, the list captured in one
    CUDA graph and replayed 3 times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * len(calls))


def main() -> int:
    import torch

    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.ops import _build
    from dtf_tpu_torch.ops import embed_gather as eg
    from dtf_tpu_torch.profile_train import card_line

    if not torch.cuda.is_available():
        raise SystemExit("profile_embed_gather: no CUDA device")
    out_dir = os.path.join(_build.BUILD_DIR, "ablate_embed")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "embed_gather.cu")
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
         os.path.join(out_dir, f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = SPARSE * BUCKETS // 2
    tables = (torch.randn(rows, 1, generator=gen, device="cuda"),
              torch.randn(rows, EMBED, generator=gen, device="cuda"))
    dtypes = (torch.float32, torch.bfloat16)
    data = SyntheticData("widedeep", BATCH, seed=0, hash_buckets=BUCKETS)
    sparse = [torch.from_numpy(data.batch(s)["sparse"]).to(torch.int32)
              .cuda() for s in range(128)]
    offsets = torch.arange(SPARSE, dtype=torch.int32,
                           device="cuda") * BUCKETS
    flats = [sp + offsets for sp in sparse]
    want = eg.masked_gather_rows_reference(tables, flats[0], 1, dtypes)

    def lookup(flat):
        return eg.masked_gather_rows_cuda(tables, flat, 1, dtypes)

    res = {name: [] for name in VARIANTS}
    real_load = _build.load
    try:
        for name in ("base", "pdl", "pdl", "base"):
            lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
            eg._lib = None
            _build.load = lambda _name, lib=lib: lib
            eg._kernel_lib()
            if not all(torch.equal(g, w)
                       for g, w in zip(lookup(flats[0]), want)):
                raise RuntimeError(f"{name}: B8 differs from its plain "
                                   "version")
            ids = graph_ms(torch, [lambda sp=sp: sp + offsets
                                   for sp in sparse])
            path = graph_ms(torch, [lambda sp=sp: lookup(sp + offsets)
                                    for sp in sparse])
            after = graph_ms(torch, [lambda f=f: lookup(f) for f in flats])
            row = {"ids": ids, "path": path - ids, "after_b8": after}
            res[name].append(row)
            print(name, row, flush=True)
    finally:
        _build.load = real_load
        eg._lib = None
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card_line(), "ids": BATCH * SPARSE,
                      "table_rows": rows, "ms": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
