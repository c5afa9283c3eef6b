"""Disk cache for compiled graph plans.

Compiling a multi-million-variable graph (coloring + per-color work-item
tables) is a once-per-graph host-side cost — tens of seconds for a
shuffled 9.4M-variable lattice on a small VM — that dominates short jobs
and experiment sweeps. The cache keys a ``CompiledGraph`` on the raw
bytes of every compile input (weights/variables/factors/fmap structured
arrays, skip list, coloring knobs, domains) so a byte-identical graph
loads its plans back in O(read) instead of recompiling.

Reference analog: none — the reference re-derives its vmap/factor_index
per process (numba's ``cache=True`` caches machine code, not graph
lowering; reference numbskull/dataloading.py:16-81 runs every load).

Storage is ``pickle`` under a user-chosen directory (opt-in: the
``cache=`` argument of ``compile_graph``, the ``--plan_cache`` CLI flag,
or the ``NSX_PLAN_CACHE`` environment variable). The cache directory is
trusted local state — entries are Python pickles, so never point it at
untrusted data.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile

import numpy as np

#: bump when CompiledGraph/ColorPlan/ItemGridPlan layout or compile
#: semantics change
SCHEMA = 2


def default_dir() -> str | None:
    """Cache directory from NSX_PLAN_CACHE ('' disables), else None."""
    d = os.environ.get("NSX_PLAN_CACHE", "")
    return d or None


def graph_key(*parts) -> str:
    """Content hash of compile inputs: arrays hash dtype+shape+bytes;
    scalars/strings hash their repr; None is distinct from 0/''."""
    h = hashlib.blake2b(digest_size=20)
    h.update(b"nsx-plan-v%d" % SCHEMA)
    for p in parts:
        if p is None:
            h.update(b"\x00N")
        elif isinstance(p, (bool, int, float, str)):
            h.update(b"\x00S" + repr(p).encode())
        else:
            a = np.ascontiguousarray(p)
            h.update(b"\x00A" + str(a.dtype).encode() +
                     repr(a.shape).encode())
            h.update(a.data if a.size else b"")
    return h.hexdigest()


def load(dirpath: str, key: str):
    """Return the cached object for ``key`` or None (corrupt/missing
    entries are treated as misses)."""
    path = os.path.join(dirpath, key + ".plan.pkl")
    try:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
            ImportError):
        return None


def store(dirpath: str, key: str, obj) -> None:
    """Atomically persist ``obj`` under ``key`` (write + rename, so a
    concurrent reader never sees a partial entry). Failures are
    silent — the cache is best-effort."""
    try:
        os.makedirs(dirpath, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dirpath, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, os.path.join(dirpath, key + ".plan.pkl"))
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass
