"""Sampler checkpoint / resume.

Port of ``numbskull_tpu/checkpoint.py``. The reference has no mid-run
persistence, only terminal text dumps (reference:
numbskull/factorgraph.py:210-229; SURVEY.md §5 "Checkpoint / resume:
none"). Here the full sampler state (both chains, weights, tallies) and
the int base seed that every draw of the run comes from round-trip
through one ``.npz``, with the JAX file's names for the four state
arrays. Where the JAX file keeps a threefry ``key``, this one keeps
``seed``: the port's draws fold the absolute epoch index into the base
seed (``ops/gibbs.epoch_seed``, ``numbskull.chunk_seed``), so a run
resumed from a checkpoint continues the same streams bit for bit. A file
that holds a JAX key cannot be resumed here and raises ``ValueError``.
Each save and load adds its wall time to the metrics
``checkpoint.save_s`` and ``checkpoint.load_s``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops.gibbs import SamplerState

_FORMAT_VERSION = 1

_STATE = ("var_value", "var_value_evid", "weight_value", "count")


def save_checkpoint(path: str, state: SamplerState, seed: int,
                    meta: dict | None = None) -> None:
    """Persist the sampler state and the base seed (and JSON-serializable
    metadata); the write is atomic (``.tmp``, then ``os.replace``)."""
    with metrics.time("checkpoint.save_s"):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        arrays = {name: getattr(state, name).cpu().numpy()
                  for name in _STATE}
        np.savez_compressed(tmp, format_version=_FORMAT_VERSION,
                            seed=np.int64(seed), meta=json.dumps(meta or {}),
                            **arrays)
        # numpy appends .npz to names without it
        written = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(written, path)


def load_checkpoint(path: str, device):
    """Returns (SamplerState on ``device``, base seed, meta dict)."""
    with metrics.time("checkpoint.load_s"), \
            np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError("%s: unknown checkpoint version %d"
                             % (path, version))
        if "seed" not in z.files:
            raise ValueError(
                "%s holds a JAX key (threefry key data), not the int base "
                "seed of numbskull_tpu_torch: a run of the JAX package "
                "cannot be resumed here" % path
                if "key" in z.files else "%s holds no seed" % path)
        state = SamplerState(**{
            name: torch.as_tensor(z[name], device=device) for name in _STATE})
        seed = int(z["seed"])
        meta = json.loads(str(z["meta"]))
    return state, seed, meta
