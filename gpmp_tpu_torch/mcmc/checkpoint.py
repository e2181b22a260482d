# gpmp_tpu_torch/mcmc/checkpoint.py
"""Checkpoint / resume for long-running samplers (counterpart of
gpmp_tpu/mcmc/checkpoint.py, NumPy and JSON only).

Format: one ``.npz`` file holding every array of the sampler state plus a
JSON-encoded metadata record (Python scalars, mode strings, the format
tag and version).  Written to ``path.tmp`` then renamed, so a reader never
sees half a file.  No pickle: a checkpoint holds no executable state, and
the caller re-supplies the log-target function on resume.

The port keeps its own meta key and format tag: its samplers draw from a
``torch.Generator`` (whose state a checkpoint holds), the JAX package's
from a PRNG key, so a checkpoint of one cannot resume the other.  Loading
a gpmp_tpu checkpoint raises; its MH state can be carried across with
``gpmp_tpu_torch.interop.mh_state_from_numpy`` and a new seed.
"""

import json
import os

import numpy as np

FORMAT = "gpmp_tpu_torch.sampler_checkpoint"
FORMAT_VERSION = 1
_META_KEY = "__gpmp_tpu_torch_meta__"
_JAX_META_KEY = "__gpmp_tpu_meta__"


def _jsonify(obj):
    """Recursively convert numpy scalars / small arrays / 0-d tensors to
    JSON types."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj


def save_sampler_checkpoint(path, arrays, meta):
    """Atomically write ``arrays`` (dict of array-likes; None entries are
    skipped) + ``meta`` (dict of JSON-serializable scalars/strings/lists)
    to ``path``."""
    payload = {}
    for name, value in arrays.items():
        if value is None:
            continue
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        payload[name] = np.asarray(value)
    meta = dict(meta)
    meta["format"] = FORMAT
    meta["format_version"] = FORMAT_VERSION
    payload[_META_KEY] = np.frombuffer(
        json.dumps(_jsonify(meta)).encode("utf-8"), dtype=np.uint8
    )
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load_sampler_checkpoint(path):
    """(arrays, meta) from a checkpoint written by save_sampler_checkpoint.

    Raises ValueError on a gpmp_tpu checkpoint, on a file without the
    port's meta record, and on another format version."""
    with np.load(path) as data:
        if _META_KEY not in data.files:
            if _JAX_META_KEY in data.files:
                raise ValueError(
                    f"{path} is a gpmp_tpu (JAX package) checkpoint: its "
                    "sampler state holds a JAX PRNG key, which the port's "
                    "samplers cannot resume.  Carry an MH state across with "
                    "gpmp_tpu_torch.interop.mh_state_from_numpy(sampler, "
                    "arrays, meta, seed=...) instead."
                )
            raise ValueError(f"{path} is not a gpmp_tpu_torch sampler checkpoint.")
        arrays = {k: data[k] for k in data.files if k != _META_KEY}
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
    if meta.get("format") != FORMAT:
        raise ValueError(f"Unknown checkpoint format {meta.get('format')!r}.")
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"Unsupported checkpoint format version {version!r} "
            f"(expected {FORMAT_VERSION})."
        )
    return arrays, meta
