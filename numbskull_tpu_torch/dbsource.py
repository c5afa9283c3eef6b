"""Relational graph source — the reference's Postgres ingest, portable.

The reference distributes graphs through PostgreSQL: every worker SELECTs
its own partition from ``*_sharding`` views written by DeepDive/ddlog
(reference: salt/src/messages.py:32-291 get_views/get_factors/
get_variables/get_weights, orchestrated by get_fg_data :371-473; master
filter salt/src/numbskull_master.py:329-334; minion filter
salt/src/numbskull_minion.py:167-175).

This module speaks plain DB-API 2.0 instead of psycopg2-only SQL, so the
same loader runs against PostgreSQL in production and sqlite3 in tests
(the reference had no test coverage for this layer at all). Schema
convention (identical to the reference's):

- ``<app>_weights_*_sharding``  : (wid, isfixed, initval)
- ``<app>_variables_*_sharding``: (vid, variable_role, init_value,
  variable_type, cardinality, partition_key)
- ``<app>_factors_<FUNC>_sharding``: (v0..v{arity-1}, weight_id,
  feature_value, partition_key, fid) — the factor function is inferred
  from the view name against the FACTORS table, like the reference
  (messages.py:157-165).

``partition_key`` grammar (reference semantics): first char = ownership
class (A master-only, B both/master-owned, C minion-only, D both/
minion-owned, E/F/G/H scheme-specific), optional 'u' = UFO-eligible,
optional trailing digits = partition id.
"""

from __future__ import annotations

import numpy as np

from numbskull_tpu_torch import types as T

MASTER_KEYS = ("A", "B", "D", "F", "G", "H")
MINION_SHARED_KEYS = ("A", "B", "H")     # A only with 'u' (cardinality info)
MINION_OWNED_KEYS = ("C", "D", "E", "F", "G")


def connect(dburl: str):
    """Open a DB-API connection from a URL.

    ``sqlite:///path`` / ``sqlite://:memory:`` → sqlite3 (always
    available); anything else → psycopg2 (production Postgres path,
    reference salt/src/numbskull_master.py:274-293).
    """
    if dburl.startswith("sqlite://"):
        import sqlite3
        path = dburl[len("sqlite://"):]
        return sqlite3.connect(path if path else ":memory:")
    try:
        import psycopg2
    except ImportError as e:  # pragma: no cover - no postgres in CI image
        raise RuntimeError(
            "psycopg2 is required for non-sqlite database URLs") from e
    return psycopg2.connect(dburl)  # pragma: no cover


def get_views(cur):
    """Discover ``*_sharding`` relations, grouped into factor/variable/
    weight views (reference messages.py:32-64)."""
    names = []
    try:
        cur.execute(
            "SELECT table_name FROM information_schema.views "
            "WHERE table_name LIKE '%_sharding'")
        names = [r[0] for r in cur.fetchall()]
    except Exception:
        cur.execute(
            "SELECT name FROM sqlite_master "
            "WHERE type IN ('view','table') AND name LIKE '%_sharding'")
        names = [r[0] for r in cur.fetchall()]
    factor_views, variable_views, weight_views = [], [], []
    for v in names:
        is_f = "_factors_" in v
        is_v = "_variables_" in v
        is_w = "_weights_" in v
        assert is_f + is_v + is_w == 1, v
        (factor_views if is_f else variable_views if is_v
         else weight_views).append(v)
    return factor_views, variable_views, weight_views


def _columns(cur, table: str):
    cur.execute("SELECT * FROM %s WHERE 1=0" % table)
    return [d[0] for d in cur.description]


def _split_pt(keys):
    """partition_key strings → (class char array, ufo bool array,
    partition-id int array; -1 when the key carries no digits).

    Key grammar (reference): class char, optional 'u' (UFO-eligible),
    optional trailing digits = partition id."""
    pt = np.array([(k or " ")[0] for k in keys], dtype="U1")
    ufo = np.array([len(k or "") > 1 and k[1] == "u" for k in keys], bool)
    pid = np.full(len(keys), -1, np.int64)
    for i, k in enumerate(keys):
        digits = "".join(ch for ch in (k or "") if ch.isdigit())
        if digits:
            pid[i] = int(digits)
    return pt, ufo, pid


def partition_filter(role: str, partition_id: int | None = None) -> str:
    """Portable SQL ownership filter (reference master filter
    numbskull_master.py:329-334, minion filter numbskull_minion.py:167-175,
    re-expressed with substr() so it runs on sqlite AND postgres)."""
    first = "substr(partition_key, 1, 1)"
    if role == "master":
        keys = ", ".join("'%s'" % k for k in MASTER_KEYS)
        return "%s IN (%s)" % (first, keys)
    assert role == "minion" and partition_id is not None
    pid = str(int(partition_id))
    shared = ["(partition_key = 'Au')",
              "(partition_key IN ('B', 'Bu'))",
              "(%s = 'H')" % first]
    owned = ["(%s = '%s' AND partition_key LIKE '%%%s')" % (first, k, pid)
             for k in MINION_OWNED_KEYS]
    return " OR ".join(shared + owned)


def get_weights(cur, views, sql_filter: str = "1=1") -> np.ndarray:
    """(W,) Weight array indexed by wid (reference messages.py:264-291).

    Bulk-fetched and column-vectorized: the reference used numba for
    exactly this hotspot (messages.py:294-368); per-row Python takes
    minutes at DeepDive production row counts."""
    rows = []
    for v in views:
        cur.execute("SELECT wid, isfixed, initval FROM %s WHERE %s"
                    % (v, sql_filter))
        rows.extend(cur.fetchall())
    if not rows:
        return T.new_weights(0)
    arr = np.asarray(rows, np.float64)
    wid = arr[:, 0].astype(np.int64)
    weight = T.new_weights(int(wid.max()) + 1)
    weight["isFixed"][wid] = arr[:, 1] != 0
    weight["initialValue"][wid] = arr[:, 2]
    return weight


def get_variables(cur, views, sql_filter: str = "1=1"):
    """(vid, Variable, var_pt, var_ufo) sorted by global vid
    (reference messages.py:212-252); numeric columns bulk-vectorized."""
    rows = []
    for v in views:
        cur.execute(
            "SELECT vid, variable_role, init_value, variable_type, "
            "cardinality, partition_key FROM %s WHERE %s"
            % (v, sql_filter))
        rows.extend(cur.fetchall())
    n = len(rows)
    variable = T.new_variables(n)
    if n:
        num = np.asarray([r[:5] for r in rows], np.int64)
        vid = num[:, 0]
        variable["isEvidence"] = num[:, 1].astype(np.int8)
        variable["initialValue"] = num[:, 2]
        variable["dataType"] = num[:, 3].astype(np.int16)
        variable["cardinality"] = num[:, 4]
        keys = [r[5] for r in rows]
    else:
        vid = np.zeros(0, np.int64)
        keys = []
    var_pt, var_ufo, var_pid = _split_pt(keys)
    perm = vid.argsort()
    return (vid[perm], variable[perm], var_pt[perm], var_ufo[perm],
            var_pid[perm])


def get_factors(cur, views, sql_filter: str = "1=1"):
    """(fid, Factor, factor_pt, factor_ufo, fmap) with fmap carrying
    GLOBAL vids (reference messages.py:67-194). The factor function comes
    from the view name matched against FACTORS (messages.py:157-165).

    Views may carry optional ``eq0..eq{arity-1}`` columns holding each
    argument's dense_equal_to (categorical equal predicates); plain
    reference-convention views (v-columns only) load with eq = 0. Rows
    are bulk-fetched and column-vectorized."""
    factor = T.new_factors(0)
    fid_l, pt_l, fmap_l = [], [], []
    fac_l = []
    for v in views:
        # longest name match wins (e.g. AND_CAT over AND); the reference
        # asserts uniqueness instead (messages.py:157-165) which its
        # ddlog-generated names guarantee
        best = ""
        for key in T.FACTORS:
            if ("_" + key + "_").lower() in v.lower() and \
                    len(key) > len(best):
                best = key
        ff = T.FACTORS[best] if best else T.FUNC_ISTRUE
        cols = _columns(cur, v)
        assert cols[-4:] == ["weight_id", "feature_value",
                             "partition_key", "fid"], cols
        n_eq = sum(c.startswith("eq") for c in cols[:-4])
        arity = len(cols) - 4 - n_eq
        assert n_eq in (0, arity), cols
        cur.execute("SELECT %s FROM %s WHERE %s ORDER BY fid"
                    % (", ".join(cols), v, sql_filter))
        rows = cur.fetchall()
        if not rows:
            continue
        pt_l.extend(r[-2] for r in rows)
        num = np.asarray([r[:-2] + (r[-1],) for r in rows], np.float64)
        m = len(rows)
        fid_l.append(num[:, -1].astype(np.int64))
        fac = T.new_factors(m)
        fac["factorFunction"] = ff
        fac["weightId"] = num[:, arity + n_eq].astype(np.int64)
        fac["featureValue"] = num[:, arity + n_eq + 1]
        fac["arity"] = arity
        fac_l.append(fac)
        fm = T.new_fmap(m * arity)
        fm["vid"] = num[:, :arity].astype(np.int64).ravel()
        if n_eq:
            fm["dense_equal_to"] = \
                num[:, arity:2 * arity].astype(np.int64).ravel()
        fmap_l.append(fm)

    if not fac_l:
        z = np.zeros(0, np.int64)
        pt, ufo, pid = _split_pt([])
        return z, T.new_factors(0), pt, ufo, pid, T.new_fmap(0)
    factor = np.concatenate(fac_l)
    fid = np.concatenate(fid_l)
    fmap = np.concatenate(fmap_l)
    factor["ftv_offset"] = np.concatenate(
        ([0], np.cumsum(factor["arity"].astype(np.int64))[:-1]))
    factor_pt, factor_ufo, factor_pid = _split_pt(pt_l)
    return fid, factor, factor_pt, factor_ufo, factor_pid, fmap


def get_fg_data(cur, sql_filter: str = "1=1", is_master: bool = True,
                mark_roles: bool = True):
    """Load a (partition of a) factor graph from the database.

    Returns ``(weight, variable, factor, fmap, domain_mask, edges, meta)``
    ready for ``NumbSkull.loadFactorGraph`` — fmap vids remapped to local
    indices (reference messages.py:358-361 remap_fmap), variables not
    owned by this role marked isEvidence=4 (reference
    numbskull_master.py:343 / numbskull_minion.py:185). ``meta`` carries
    the global id maps and partition metadata for boundary exchange.
    """
    factor_views, variable_views, weight_views = get_views(cur)
    weight = get_weights(cur, weight_views)          # weights replicate
    (vid, variable, var_pt, var_ufo, var_pid) = get_variables(
        cur, variable_views, sql_filter)
    (fid, factor, factor_pt, factor_ufo, factor_pid, fmap) = get_factors(
        cur, factor_views, sql_filter)

    # global -> local vid remap via the sorted vid array
    local = np.searchsorted(vid, fmap["vid"].astype(np.int64))
    assert (local < len(vid)).all() and \
        (vid[local] == fmap["vid"].astype(np.int64)).all(), \
        "factor references a variable outside this partition's filter"
    fmap = fmap.copy()
    fmap["vid"] = local

    if mark_roles:
        not_owned = "D" if is_master else "B"
        variable = variable.copy()
        variable["isEvidence"] = np.where(
            var_pt == not_owned, np.int8(4), variable["isEvidence"])

    domain_mask = np.zeros(len(variable), bool)
    meta = dict(vid=vid, fid=fid, var_pt=var_pt, var_ufo=var_ufo,
                var_pid=var_pid, factor_pt=factor_pt,
                factor_ufo=factor_ufo, factor_pid=factor_pid)
    return weight, variable, factor, fmap, domain_mask, len(fmap), meta


# --- test/experiment helper: publish arrays as sharding tables -------------

def write_graph_to_db(cur, app: str, weights, variables, factors, fmap,
                      var_keys=None, factor_keys=None):
    """Publish structured arrays as reference-convention sharding tables
    (one factor table per (function, arity)); the inverse of get_fg_data,
    used by tests and experiment drivers (the reference relied on
    DeepDive/ddlog to create these views)."""
    ffname = {v: k for k, v in T.FACTORS.items()}
    q = "%s" if "psycopg2" in type(cur).__module__ else "?"
    cur.execute("CREATE TABLE %s_weights_sharding "
                "(wid INTEGER, isfixed INTEGER, initval REAL)" % app)
    cur.executemany(
        "INSERT INTO %s_weights_sharding VALUES (%s)"
        % (app, ", ".join([q] * 3)),
        [(i, int(w["isFixed"]), float(w["initialValue"]))
         for i, w in enumerate(weights)])

    if var_keys is None:
        var_keys = ["B"] * len(variables)
    cur.execute("CREATE TABLE %s_variables_sharding "
                "(vid INTEGER, variable_role INTEGER, init_value INTEGER, "
                "variable_type INTEGER, cardinality INTEGER, "
                "partition_key TEXT)" % app)
    cur.executemany(
        "INSERT INTO %s_variables_sharding VALUES (%s)"
        % (app, ", ".join([q] * 6)),
        [(i, int(v["isEvidence"]), int(v["initialValue"]),
          int(v["dataType"]), int(v["cardinality"]), var_keys[i])
         for i, v in enumerate(variables)])

    if factor_keys is None:
        factor_keys = ["B"] * len(factors)
    eqs = fmap["dense_equal_to"].astype(np.int64)
    groups = {}
    for i, f in enumerate(factors):
        groups.setdefault((int(f["factorFunction"]), int(f["arity"])),
                          []).append(i)
    for (ff, arity), fids in groups.items():
        # eq columns only when some argument carries a nonzero
        # dense_equal_to (categorical equal predicates survive the DB
        # round trip; plain boolean tables keep the reference schema)
        offs = factors["ftv_offset"][fids].astype(np.int64)
        span = (offs[:, None] + np.arange(arity)).ravel()
        with_eq = bool((eqs[span] != 0).any())
        tbl = "%s_factors_%s_a%d_sharding" % (app, ffname[ff].lower(), arity)
        vcols = ", ".join("v%d INTEGER" % j for j in range(arity))
        eqcols = "".join(", eq%d INTEGER" % j for j in range(arity)) \
            if with_eq else ""
        cur.execute("CREATE TABLE %s (%s%s, weight_id INTEGER, "
                    "feature_value REAL, partition_key TEXT, fid INTEGER)"
                    % (tbl, vcols, eqcols))
        ph = ", ".join([q] * (arity + (arity if with_eq else 0) + 4))
        rows = []
        for i in fids:
            off = int(factors[i]["ftv_offset"])
            vids = [int(fmap[off + j]["vid"]) for j in range(arity)]
            eqv = [int(eqs[off + j]) for j in range(arity)] \
                if with_eq else []
            rows.append((*vids, *eqv, int(factors[i]["weightId"]),
                         float(factors[i]["featureValue"]),
                         factor_keys[i], i))
        cur.executemany("INSERT INTO %s VALUES (%s)" % (tbl, ph), rows)


# --- DB partition metadata -> distributed engine -----------------------------

def partition_from_keys(var_pt: np.ndarray,
                        var_pid: np.ndarray) -> np.ndarray:
    """Variable partition from partition keys: master-class keys (A/B/H)
    map to part 0, minion-class keys (C/D/E/F/G) to part pid+1 — the
    reference's ownership convention (numbskull_master.py:329-343,
    numbskull_minion.py:167-185) expressed as a part vector."""
    master = np.isin(var_pt, ("A", "B", "H"))
    pid = np.where(var_pid < 0, 0, var_pid)
    raw = np.where(master, 0, pid + 1).astype(np.int64)
    # densify: minion pids need not be contiguous (master stays first)
    _, dense = np.unique(raw, return_inverse=True)
    return dense.astype(np.int64)


def bsp_from_db(cur, mode: str | None = None, itemgrid: bool = False,
                seed: int = 0, device="cuda"):
    """Load a FULL keyed graph and build a partitioned BSP engine from
    its partition metadata — the reference's DB -> partition ->
    distributed-engine path (numbskull_master.py:327-346 load_all_fg)
    without Postgres-specific plumbing.

    ``mode=None`` picks automatically from the UFO flags: when every
    straddling factor is marked UFO-eligible, boundary traffic uses
    per-value potential messages (the UFO/PF generalization); otherwise
    ghost values ship (the reference's default exchange).

    Returns (engine, part, meta). ``itemgrid=True`` builds
    BSPItemGridInference (fused kernels per part) instead of the XLA
    BSPEngine.
    """
    from numbskull_tpu_torch.parallel.bsp import (
        BSPEngine, BSPItemGridInference, factor_owner,
    )

    # full-graph load, no role marking (ownership comes from part)
    (weight, variable, factor, fmap, domain_mask, edges,
     meta) = get_fg_data(cur, "1=1", mark_roles=False)
    part = partition_from_keys(meta["var_pt"], meta["var_pid"])
    if mode is None:
        owner = factor_owner(factor, fmap, part)
        fvid = fmap["vid"].astype(np.int64)
        arity = factor["arity"].astype(np.int64)
        edge_fid = np.repeat(np.arange(len(factor)), arity)
        straddles = np.zeros(len(factor), bool)
        np.logical_or.at(straddles, edge_fid,
                         part[fvid] != owner[edge_fid])
        ufo_ok = meta["factor_ufo"] | ~straddles
        mode = "messages" if ufo_ok.all() else "values"
    if itemgrid:
        eng = BSPItemGridInference(weight, variable, factor, fmap, part,
                                   mode=mode, domain_mask=domain_mask,
                                   seed=seed, device=device)
    else:
        eng = BSPEngine(weight, variable, factor, fmap, part, mode=mode,
                        domain_mask=domain_mask, seed=seed, device=device)
    return eng, part, meta
