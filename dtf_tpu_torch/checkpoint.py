"""The model-config manifest (the port's copy of ``dtf_tpu.checkpoint``'s reader).

The JAX training launcher writes ``model_config.json`` next to its
checkpoint; the serving entry points read it so that the architecture
they decode with is the one that was trained. Restoring the Orbax
checkpoint itself is not ported yet.
"""

from __future__ import annotations

import json
import logging
import os

log = logging.getLogger("dtf_tpu_torch")

MODEL_CONFIG_BASENAME = "model_config.json"


def load_model_config(directory: str | os.PathLike) -> dict | None:
    """The manifest in ``directory``, or None (no manifest, or an
    unreadable one — callers fall back to flags, loudly)."""
    path = os.path.join(os.fspath(directory), MODEL_CONFIG_BASENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError) as e:
        log.warning("unreadable %s (%s); falling back to flags", path, e)
        return None
