"""The decode-config merge of the serving launcher (the port's copy of
``dtf_tpu.cli.flags.resolve_decode_config``), over ``argparse`` flags."""

from __future__ import annotations

#: decode-config fields the checkpoint manifest is authoritative for: a
#: hand-matched mismatch on any of these silently garbles decode.
DECODE_MANIFEST_FIELDS = ("size", "kv_heads", "attn_window",
                          "attn_global_every")


def resolve_decode_config(args, manifest, present=frozenset()) -> dict:
    """Merge the checkpoint's ``model_config.json`` manifest into the flags.

    ``present`` names the flags given on the command line. Manifest
    present: its architecture fields WIN — a given flag that contradicts
    it raises, a matching or unset flag follows it. No manifest: the flags
    pass through. ``kv_cache_dtype`` is a serving-side choice: the flag
    wins when given, the manifest only supplies a default. Raises
    ValueError — the launcher turns it into a usage error.
    """
    out = {f: getattr(args, f) for f in DECODE_MANIFEST_FIELDS}
    out["kv_cache_dtype"] = getattr(args, "kv_cache_dtype", "")
    if manifest is not None:
        if int(manifest.get("moe_every", 0) or 0):
            raise ValueError(
                f"checkpoint was trained with moe_every="
                f"{manifest['moe_every']}; the decode stack has no MoE "
                "path — serving a Switch-MoE checkpoint would silently "
                "drop the expert weights")
        for f in DECODE_MANIFEST_FIELDS:
            if f not in manifest:
                continue
            if f in present and getattr(args, f) != manifest[f]:
                raise ValueError(
                    f"--{f}={getattr(args, f)!r} contradicts the "
                    f"checkpoint manifest ({manifest[f]!r}); drop the "
                    "flag — the manifest written by the training launcher "
                    "is authoritative")
            out[f] = manifest[f]
        if "kv_cache_dtype" not in present and "kv_cache_dtype" in manifest:
            out["kv_cache_dtype"] = manifest["kv_cache_dtype"]
    _validate_kv_cache_dtype(out["kv_cache_dtype"], manifest)
    return out


def _validate_kv_cache_dtype(dtype: str, manifest) -> None:
    if dtype not in ("", "int8"):
        raise ValueError(
            f"kv_cache_dtype={dtype!r} must be '' (store at model dtype) "
            "or 'int8'")
    if dtype == "int8" and manifest is not None:
        d_model = int(manifest.get("d_model", 0) or 0)
        heads = int(manifest.get("heads", 0) or 0)
        if d_model and heads and (d_model // heads) % 2:
            raise ValueError(
                f"kv_cache_dtype=int8 needs an even head dim (rope pairs "
                f"lanes); manifest says d_model={d_model} / heads={heads} "
                f"-> d_head={d_model // heads}")
