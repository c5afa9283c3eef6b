"""DeepDive binary grounding-format I/O.

Byte-compatible with the reference loaders (reference:
numbskull/dataloading.py:103-237) and the reference's C++ generator
(reference: ising/ising.cpp:88-130), but implemented as *vectorized* numpy
big-endian structured-dtype parses instead of byte-at-a-time JIT loops:

- ``graph.meta``      CSV text: weights,variables,factors,edges[,...]
- ``graph.weights``   17-byte records  [weightId:>i8][isFixed:u1][initialValue:>f8]
- ``graph.variables`` 27-byte records  [variableId:>i8][isEvidence:u1]
                      [initialValue:>i8][dataType:>i2][cardinality:>i8]
- ``graph.factors``   variable-length  [factorFunction:>i2][arity:>i8]
                      ([vid:>i8][equalPredicate:>i8] x arity)
                      [weightId:>i8][featureValue:>f8]
- ``graph.domains``   variable-length  [variableId:>i8][cardinality:>i8]
                      ([value:>i8] x cardinality)

Variable-length factor records are parsed in vectorized *runs* of equal
arity (grounded graphs group factors by relation, so runs are long); the
worst case degrades gracefully, never breaks.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from numbskull_tpu_torch import types

_FASTLOAD = None


def _fastload():
    """ctypes handle to the native factor-stream scanner, if built.

    Build with `make -C native libfastload.so`; override the path with
    NUMBSKULL_TPU_FASTLOAD. Returns None when unavailable (the numpy
    run-parser below is the fallback).
    """
    global _FASTLOAD
    if _FASTLOAD is not None:
        return _FASTLOAD or None
    candidates = [os.environ.get("NUMBSKULL_TPU_FASTLOAD", "")]
    here = os.path.dirname(os.path.abspath(__file__))
    native_dir = os.path.join(here, "..", "native")
    so_path = os.path.join(native_dir, "libfastload.so")
    if (not candidates[0] and not os.path.isfile(so_path)
            and os.path.isfile(os.path.join(native_dir, "Makefile"))):
        # binaries are gitignored; build once on first use under the
        # shared build lock (numpy fallback covers any failure)
        from numbskull_tpu_torch.compile import _build_native
        _build_native(native_dir)
    candidates.append(so_path)
    candidates.append(os.path.join(here, "libfastload.so"))
    for path in candidates:
        if path and os.path.isfile(path):
            from numbskull_tpu_torch.compile import _load_native
            lib = _load_native(
                path, native_dir if path == so_path else None)
            if lib is None:
                continue
            lib.fastload_factors.restype = ctypes.c_int
            _FASTLOAD = lib
            return lib
    _FASTLOAD = False
    return None

_WEIGHT_REC = np.dtype([("weightId", ">i8"),
                        ("isFixed", "u1"),
                        ("initialValue", ">f8")])

_VARIABLE_REC = np.dtype([("variableId", ">i8"),
                          ("isEvidence", "u1"),
                          ("initialValue", ">i8"),
                          ("dataType", ">i2"),
                          ("cardinality", ">i8")])


def load_meta(path: str) -> np.ndarray:
    """Parse graph.meta (CSV header; reference numbskull.py:265-268)."""
    with open(path) as f:
        fields = f.read().strip().split(",")
    meta = np.zeros((), types.Meta)
    meta["weights"] = int(fields[0])
    meta["variables"] = int(fields[1])
    meta["factors"] = int(fields[2])
    meta["edges"] = int(fields[3])
    return meta


def load_weights(data: bytes, nweights: int) -> np.ndarray:
    """Parse graph.weights → Weight array indexed by weightId."""
    rec = np.frombuffer(data, dtype=_WEIGHT_REC, count=nweights)
    weights = np.zeros(nweights, types.Weight)
    wid = rec["weightId"].astype(np.int64)
    weights["isFixed"][wid] = rec["isFixed"] != 0
    weights["initialValue"][wid] = rec["initialValue"]
    return weights


def load_variables(data: bytes, nvariables: int) -> np.ndarray:
    """Parse graph.variables → Variable array indexed by variableId."""
    rec = np.frombuffer(data, dtype=_VARIABLE_REC, count=nvariables)
    variables = np.zeros(nvariables, types.Variable)
    vid = rec["variableId"].astype(np.int64)
    variables["isEvidence"][vid] = rec["isEvidence"].astype(np.int8)
    variables["initialValue"][vid] = rec["initialValue"]
    variables["dataType"][vid] = rec["dataType"]
    variables["cardinality"][vid] = rec["cardinality"]
    return variables


def assign_vtf_offsets(variables: np.ndarray) -> int:
    """Assign Variable.vtf_offset in place; return total #VTF slots.

    Booleans get one slot, categoricals one per domain value
    (reference: numbskull/numbskull.py:310-317).
    """
    slots = np.where(variables["dataType"] == 0, 1, variables["cardinality"])
    offsets = np.concatenate(([0], np.cumsum(slots)[:-1]))
    variables["vtf_offset"] = offsets
    return int(slots.sum())


def load_domains(data: bytes, domain_mask: np.ndarray, vmap: np.ndarray,
                 variables: np.ndarray) -> None:
    """Parse graph.domains; fill vmap['value'] and densify initialValue.

    Reference: numbskull/dataloading.py:159-187. All fields are >i8 so the
    file is one flat big-endian int64 stream.
    """
    flat = np.frombuffer(data, dtype=">i8").astype(np.int64)
    index = 0
    n = flat.size
    while index < n:
        vid = flat[index]
        card = flat[index + 1]
        vals = flat[index + 2: index + 2 + card]
        index += 2 + card
        domain_mask[vid] = True
        off = variables["vtf_offset"][vid]
        vmap["value"][off:off + card] = vals
        # translate initial value into dense index
        hit = np.nonzero(vals == variables["initialValue"][vid])[0]
        if hit.size:
            variables["initialValue"][vid] = hit[0]


def _factor_run_dtype(arity: int) -> np.dtype:
    return np.dtype([("factorFunction", ">i2"),
                     ("arity", ">i8"),
                     ("refs", [("vid", ">i8"), ("equal", ">i8")], (arity,)),
                     ("weightId", ">i8"),
                     ("featureValue", ">f8")])


def load_factors(data: bytes, nfactors: int, nedges: int,
                 domain_mask: np.ndarray | None = None,
                 variables: np.ndarray | None = None,
                 vmap: np.ndarray | None = None):
    """Parse graph.factors → (Factor array, FactorToVar array).

    Vectorized run-parsing: probe the arity of the record at the current
    offset, then parse the longest prefix of consecutive records sharing
    that arity in one structured-dtype frombuffer.

    When ``domain_mask``/``variables``/``vmap`` are given, equal-predicate
    values of explicit-domain categorical args are densified via binary
    search, matching reference numbskull/dataloading.py:219-223.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    factors = np.zeros(nfactors, types.Factor)
    fmap = np.zeros(nedges, types.FactorToVar)

    lib = _fastload()
    if lib is not None and nfactors:
        ff = np.zeros(nfactors, np.int16)
        ar = np.zeros(nfactors, np.int64)
        fo = np.zeros(nfactors, np.int64)
        wid = np.zeros(nfactors, np.int64)
        fv = np.zeros(nfactors, np.float64)
        vid = np.zeros(nedges, np.int64)
        eq = np.zeros(nedges, np.int64)
        p = ctypes.POINTER
        rc = lib.fastload_factors(
            buf.ctypes.data_as(p(ctypes.c_uint8)),
            ctypes.c_int64(buf.size),
            ctypes.c_int64(nfactors), ctypes.c_int64(nedges),
            ff.ctypes.data_as(p(ctypes.c_int16)),
            ar.ctypes.data_as(p(ctypes.c_int64)),
            fo.ctypes.data_as(p(ctypes.c_int64)),
            wid.ctypes.data_as(p(ctypes.c_int64)),
            fv.ctypes.data_as(p(ctypes.c_double)),
            vid.ctypes.data_as(p(ctypes.c_int64)),
            eq.ctypes.data_as(p(ctypes.c_int64)))
        if rc != 0:
            raise ValueError(f"corrupt graph.factors stream (rc={rc})")
        factors["factorFunction"] = ff
        factors["arity"] = ar
        factors["ftv_offset"] = fo
        factors["weightId"] = wid
        factors["featureValue"] = fv
        fmap["vid"] = vid
        fmap["dense_equal_to"] = eq
        return _densify_equal_predicates(factors, fmap, domain_mask,
                                         variables, vmap)

    offset = 0
    fi = 0       # next factor slot
    ei = 0       # next fmap slot
    total = buf.size
    arity_probe = np.dtype(">i8")
    while fi < nfactors:
        arity = int(np.frombuffer(buf, dtype=arity_probe, count=1,
                                  offset=offset + 2)[0])
        rec_size = 2 + 8 + 16 * arity + 16
        # longest run of records with this arity: probe candidate arities
        max_here = min(nfactors - fi, (total - offset) // rec_size)
        run = max_here
        if max_here > 1:
            cand_off = offset + np.arange(max_here, dtype=np.int64) * rec_size
            # gather the 8 arity bytes of each candidate record
            idx = cand_off[:, None] + 2 + np.arange(8)
            cand_arity = buf[idx].copy().view(">i8").ravel()
            mismatch = np.nonzero(cand_arity != arity)[0]
            if mismatch.size:
                run = int(mismatch[0])
        rec = np.frombuffer(buf, dtype=_factor_run_dtype(arity), count=run,
                            offset=offset)
        sl = slice(fi, fi + run)
        factors["factorFunction"][sl] = rec["factorFunction"]
        factors["arity"][sl] = arity
        factors["weightId"][sl] = rec["weightId"]
        factors["featureValue"][sl] = rec["featureValue"]
        factors["ftv_offset"][sl] = ei + np.arange(run, dtype=np.int64) * arity

        vids = rec["refs"]["vid"].astype(np.int64).ravel()
        equals = rec["refs"]["equal"].astype(np.int64).ravel()
        fmap["vid"][ei:ei + run * arity] = vids
        fmap["dense_equal_to"][ei:ei + run * arity] = equals

        fi += run
        ei += run * arity
        offset += run * rec_size

    return _densify_equal_predicates(factors, fmap, domain_mask, variables,
                                     vmap)


def _densify_equal_predicates(factors, fmap, domain_mask, variables, vmap):
    """Equal-predicates of explicit-domain categorical args -> dense
    indices by bisect (reference numbskull/dataloading.py:219-223)."""
    if domain_mask is not None and domain_mask.any():
        assert variables is not None and vmap is not None
        vids = fmap["vid"]
        need = domain_mask[vids]
        if need.any():
            idx = np.nonzero(need)[0]
            for j in idx:  # domains are rare; per-edge bisect like reference
                vid = vids[j]
                start = variables["vtf_offset"][vid]
                end = start + variables["cardinality"][vid]
                fmap["dense_equal_to"][j] = np.searchsorted(
                    vmap["value"][start:end], fmap["dense_equal_to"][j])
    return factors, fmap


def load_factor_graph_files(directory: str,
                            metafile: str = "graph.meta",
                            weightfile: str = "graph.weights",
                            variablefile: str = "graph.variables",
                            factorfile: str = "graph.factors",
                            domainfile: str = "graph.domains"):
    """Load a full DeepDive binary factor graph from a directory.

    Returns (meta, weights, variables, factors, fmap, vmap_values,
    domain_mask); mirrors reference numbskull.py:245-353 up to (but not
    including) vmap/factor-index construction, which lives in
    `numbskull_tpu.compile`.
    """
    meta = load_meta(os.path.join(directory, metafile))
    with open(os.path.join(directory, weightfile), "rb") as f:
        weights = load_weights(f.read(), int(meta["weights"]))
    with open(os.path.join(directory, variablefile), "rb") as f:
        variables = load_variables(f.read(), int(meta["variables"]))

    num_vtf = assign_vtf_offsets(variables)
    vmap = np.zeros(num_vtf, types.VarToFactor)
    domain_mask = np.zeros(int(meta["variables"]), np.bool_)

    domain_path = os.path.join(directory, domainfile)
    if os.path.isfile(domain_path) and os.stat(domain_path).st_size > 0:
        with open(domain_path, "rb") as f:
            load_domains(f.read(), domain_mask, vmap, variables)

    with open(os.path.join(directory, factorfile), "rb") as f:
        factors, fmap = load_factors(f.read(), int(meta["factors"]),
                                     int(meta["edges"]),
                                     domain_mask, variables, vmap)
    return meta, weights, variables, factors, fmap, vmap, domain_mask


# --- Writers (byte-compatible with reference ising/ising.cpp:88-130) -------

def write_factor_graph_files(directory: str,
                             weights: np.ndarray,
                             variables: np.ndarray,
                             factors: np.ndarray,
                             fmap: np.ndarray,
                             domains: dict[int, np.ndarray] | None = None,
                             meta_extra: str = "") -> None:
    """Write a factor graph in DeepDive binary format."""
    os.makedirs(directory, exist_ok=True)
    nedges = int(factors["arity"].sum())
    assert nedges == len(fmap), (nedges, len(fmap))

    with open(os.path.join(directory, "graph.meta"), "w") as f:
        line = "%d,%d,%d,%d" % (len(weights), len(variables), len(factors),
                                nedges)
        if meta_extra:
            line += "," + meta_extra
        f.write(line)

    wrec = np.zeros(len(weights), _WEIGHT_REC)
    wrec["weightId"] = np.arange(len(weights))
    wrec["isFixed"] = weights["isFixed"]
    wrec["initialValue"] = weights["initialValue"]
    wrec.tofile(os.path.join(directory, "graph.weights"))

    vrec = np.zeros(len(variables), _VARIABLE_REC)
    vrec["variableId"] = np.arange(len(variables))
    vrec["isEvidence"] = variables["isEvidence"]
    vrec["initialValue"] = variables["initialValue"]
    vrec["dataType"] = variables["dataType"]
    vrec["cardinality"] = variables["cardinality"]
    vrec.tofile(os.path.join(directory, "graph.variables"))

    with open(os.path.join(directory, "graph.factors"), "wb") as f:
        # write in runs of equal arity
        arity = factors["arity"]
        n = len(factors)
        i = 0
        while i < n:
            a = arity[i]
            j = i + 1
            while j < n and arity[j] == a:
                j += 1
            run = j - i
            rec = np.zeros(run, _factor_run_dtype(int(a)))
            rec["factorFunction"] = factors["factorFunction"][i:j]
            rec["arity"] = a
            rec["weightId"] = factors["weightId"][i:j]
            rec["featureValue"] = factors["featureValue"][i:j]
            offs = factors["ftv_offset"][i:j]
            edge_idx = offs[:, None] + np.arange(a)
            rec["refs"]["vid"] = fmap["vid"][edge_idx]
            rec["refs"]["equal"] = fmap["dense_equal_to"][edge_idx]
            rec.tofile(f)
            i = j

    if domains:
        with open(os.path.join(directory, "graph.domains"), "wb") as f:
            for vid, vals in sorted(domains.items()):
                head = np.array([vid, len(vals)], dtype=">i8")
                head.tofile(f)
                np.asarray(vals, dtype=">i8").tofile(f)
