"""Checkpoint and resume in the port, on the CPU.

Mirrors tests/test_checkpoint.py: a run saved, loaded and continued
equals the uninterrupted run bit for bit, on the tensor-op GibbsEngine
(whose epochs draw at absolute indices, so chunks of any size compose)
and on the kernels' plain versions. Across packages: chunks 0 and 1 of
an itemgrid run go through the JAX package's interpret-mode kernel and
its ``save_checkpoint``; the port reads the file's four state arrays and
runs chunk 2, which must equal the JAX run's chunk 2 bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from numbskull_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu.ops.gibbs import LearnParams as JaxLearnParams
from numbskull_tpu.ops.gibbs import SamplerState as JaxSamplerState
from numbskull_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.convert import (compiled_graph_from_reference,
                                         sampler_state_from_reference)
from numbskull_tpu_torch.models import coin_model, ising_grid
from numbskull_tpu_torch.numbskull import chunk_seed
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import GibbsEngine, LearnParams
from test_torch_itemgrid import schedule_from_jax_plan
from test_torch_learn import _coin as jax_coin
from test_torch_learn import _ising16 as jax_ising16
from test_torch_learn import learn_schedule_from_jax_plan

from _torch_threads import cap_threads

cap_threads()

STATE = ("var_value", "var_value_evid", "weight_value", "count")


def _ising_engine(n=4, weight=0.3, fixed=True):
    w, v, f, fm, dm, _ = ising_grid(n, n, weight=weight, fixed=fixed)
    return GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                       device="cpu")


def _assert_states_equal(a, b):
    for name in STATE:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_resume_bit_exact(tmp_path):
    """Two calls of 25 epochs (the second at epoch_offset 25) == the same
    with a save and load in between (tests/test_checkpoint.py:13-38)."""
    eng = _ising_engine()
    st = eng.inference(eng.init_state(), 42, 25, burn=10)
    full = eng.inference(st, 42, 25, epoch_offset=25)

    st2 = eng.inference(eng.init_state(), 42, 25, burn=10)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, st2, 42, meta={"epochs_done": 25})
    st3, seed, meta = load_checkpoint(path, "cpu")
    assert (seed, meta) == (42, {"epochs_done": 25})
    resumed = eng.inference(st3, seed, 25, epoch_offset=25)
    _assert_states_equal(full, resumed)
    assert not os.path.exists(path + ".tmp.npz")


def test_checkpoint_preserves_weights(tmp_path):
    """The weights, and every array's dtype, survive the round trip
    (tests/test_checkpoint.py:41-50)."""
    eng = _ising_engine(3, 0.7, fixed=False)
    st = eng.init_state()
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, st, 0)
    st2, _, _ = load_checkpoint(path, "cpu")
    assert st2.weight_value.numpy()[0] == np.float32(0.7)
    _assert_states_equal(st, st2)
    assert st2.count.dtype == torch.int32


@pytest.mark.parametrize("chunk", [1, 7, 40])
def test_gibbs_inference_chunks_equal_one_call(chunk):
    """GibbsEngine.inference in chunks of any size (burn-in in the first,
    each at its epoch_offset) == one call of 40 epochs, bit for bit."""
    eng = _ising_engine(6, 0.4)
    whole = eng.inference(eng.init_state(), 9, 40, burn=3)
    st, done = eng.init_state(), 0
    while done < 40:
        n = min(chunk, 40 - done)
        st = eng.inference(st, 9, n, burn=3 if done == 0 else 0,
                           epoch_offset=done)
        done += n
    _assert_states_equal(whole, st)


def test_gibbs_inference_offset_changes_the_stream():
    """The offset selects the epochs' streams: a second chunk drawn at
    offset 0 (the first chunk's streams again) tallies differently from
    the same chunk at its own offset, 10."""
    eng = _ising_engine(8, 0.1)
    st = eng.inference(eng.init_state(), 3, 10)
    right = eng.inference(st, 3, 10, epoch_offset=10)
    wrong = eng.inference(st, 3, 10, epoch_offset=0)
    assert not torch.equal(right.count, wrong.count)


def test_gibbs_learning_resume_exact(tmp_path):
    """GibbsEngine.learn in chunks of 20 (stepsize * decay**done, each at
    its epoch_offset), interrupted after the second and resumed from its
    checkpoint, == the uninterrupted chunked run: weights and both
    chains bit for bit."""
    w, v, f, fm, dm, _ = coin_model(200, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device="cpu")
    lp = LearnParams(regularization=1, reg_param=0.01, truncation=2)

    def chunks(st, lo, hi):
        for done in range(lo, hi, 20):
            st = eng.learn(st, 11, 20, 0.1 * 0.97 ** done, 0.97,
                           burn=2 if done == 0 else 0, lp=lp,
                           epoch_offset=done)
        return st

    clean = chunks(eng.init_state(), 0, 60)
    path = str(tmp_path / "l.npz")
    save_checkpoint(path, chunks(eng.init_state(), 0, 40), 11,
                    meta={"learn_epochs_done": 40})
    st, seed, meta = load_checkpoint(path, "cpu")
    resumed = chunks(st, meta["learn_epochs_done"], 60)
    _assert_states_equal(clean, resumed)
    assert not torch.equal(clean.weight_value, eng.init_state().weight_value)


def test_load_refuses_a_jax_checkpoint(tmp_path):
    """A file written by the JAX package holds a threefry key, not the
    port's int seed: loading it raises ValueError and says so."""
    path = str(tmp_path / "jax.npz")
    z = np.zeros(4, np.int32)
    jax_save_checkpoint(path, JaxSamplerState(
        var_value=z, var_value_evid=z, weight_value=np.zeros(1, np.float32),
        count=np.zeros((4, 2), np.int32)), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="JAX key"):
        load_checkpoint(path, "cpu")


@pytest.mark.parametrize("task", ["inference", "learning"])
def test_jax_chunks_then_port_chunk_is_bit_exact(tmp_path, task):
    """Chunks 0 and 1 through the JAX PallasItemGridEngine (interpret
    mode), its state written by the JAX save_checkpoint; the port reads
    the file's four state arrays (np.load), carries them over
    (convert.sampler_state_from_reference) and runs chunk 2 through
    ItemGridEngine's plain versions with the JAX run's seed of chunk 2:
    values, tallies (inference) or weights and both chains (learning)
    equal the JAX run's chunk 2 bit for bit. Dyadic weights (Ising 16x16
    at 0.25, 30 % evidence) or integer gradient sums (coin) make every
    sum exact."""
    learn = task == "learning"
    cg = jax_coin() if learn else jax_ising16()
    plan, reason = jig.plan_item_grid(cg, True)
    assert plan is not None, reason
    jeng = jig.PallasItemGridEngine(cg, interpret=True)
    lpk = dict(regularization=2, reg_param=1e-4)
    base, n, burn, step, decay = 17, 4, 2, 0.1, 0.98

    x = np.asarray(cg.var_init, np.int32)
    xe = x.copy()
    w = np.asarray(cg.weight_init, np.float32)
    cnt = np.zeros((cg.n_vars, cg.kmax), np.int32)

    def jax_chunk(c, x, xe, w, cnt):
        seed = chunk_seed(base, c * n)
        b = burn if c == 0 else 0
        if learn:
            w, x, xe = jeng.learn(seed, b, n, step * decay ** (c * n), decay,
                                  lp=JaxLearnParams(**lpk), weight_value=w,
                                  x0=x, xe0=xe, return_state=True)
        else:
            x, counts = jeng.run(seed, b, n, weight_value=w, x0=x)
            cnt = cnt + np.asarray(counts)[:, :cnt.shape[1]]
        return (np.asarray(x, np.int32), np.asarray(xe, np.int32),
                np.asarray(w, np.float32), cnt)

    for c in (0, 1):
        x, xe, w, cnt = jax_chunk(c, x, xe, w, cnt)
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, JaxSamplerState(
        var_value=x, var_value_evid=xe, weight_value=w, count=cnt),
        jax.random.PRNGKey(base), meta={"epochs_done": 2 * n})
    want = jax_chunk(2, x, xe, w, cnt)

    with np.load(path) as z:
        st = sampler_state_from_reference(*(z[k] for k in STATE),
                                          device="cpu")
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    sched = (learn_schedule_from_jax_plan if learn else
             schedule_from_jax_plan)(cg, plan)
    eng = pig.ItemGridEngine(pcg, device="cpu", schedule=sched)
    seed = chunk_seed(base, 2 * n)
    if learn:
        w2, x2, xe2 = eng.learn(seed, 0, n, step * decay ** (2 * n), decay,
                                LearnParams(**lpk),
                                weight_value=st.weight_value,
                                x0=st.var_value, xe0=st.var_value_evid)
        got = (x2.numpy(), xe2.numpy(), w2.numpy())
        np.testing.assert_array_equal(got[2], want[2])
        assert not np.array_equal(got[2], w)           # learning moved it
    else:
        x2, counts = eng.run(seed, 0, n, weight_value=st.weight_value,
                             x0=st.var_value)
        got = (x2.numpy(), (st.count + counts).numpy())
        np.testing.assert_array_equal(got[1], want[3])
        assert int(got[1].sum()) > int(cnt.sum())
    np.testing.assert_array_equal(got[0], want[0])
    if learn:
        np.testing.assert_array_equal(got[1], want[1])
