"""Failure detection, fault injection, and checkpoint-based recovery.

Port of ``numbskull_tpu/resilience.py``. The reference's failure story is
a liveness poll before start and a FAIL status that aborts the whole run
(reference: salt/src/numbskull_master.py:506-544,
salt/src/numbskull_minion.py:70-91; SURVEY.md §5: "No elasticity, no
checkpoint-based recovery, no fault injection"). Here:

- ``run_resilient``: drives an ``ops/gibbs.GibbsEngine`` in checkpointed
  chunks; any failure restores the last checkpoint and retries. A chunk
  draws from the run's base seed at its absolute epoch index
  (``epoch_offset``), so the recovered run is bit-exact with an
  uninterrupted one.
- ``FaultInjector``: deterministic fault injection for testing the
  recovery path (fails at chosen chunk indices).
- ``call_with_timeout``: stall detection for device calls. The caller
  gets a ``StallError`` after ``timeout_s`` even if the call is hung (the
  work itself cannot be cancelled; the caller decides whether to reset
  the device or abort).
"""

from __future__ import annotations

import concurrent.futures as _futures
import os

import torch

from numbskull_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from numbskull_tpu_torch.observability import metrics


class StallError(RuntimeError):
    pass


def call_with_timeout(fn, timeout_s: float, *args, **kwargs):
    """Run fn in a worker thread; raise StallError if it exceeds
    timeout_s (the hung call keeps running, since device work cannot be
    cancelled, but the caller regains control)."""
    with _futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=timeout_s)
        except _futures.TimeoutError:
            raise StallError(
                "call exceeded %.1fs (device stall?)" % timeout_s) from None


class FaultInjector:
    """Raises RuntimeError before executing the chunks in ``fail_at``
    (each index fires once): deterministic failure for recovery tests."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def __call__(self, chunk_index: int) -> None:
        if chunk_index in self.fail_at and chunk_index not in self.fired:
            self.fired.add(chunk_index)
            raise RuntimeError("injected fault at chunk %d" % chunk_index)


def _sync(state) -> None:
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)


def run_resilient(engine, state, seed: int, epochs: int, ckpt_path: str,
                  chunk: int = 100, burn: int = 0,
                  max_retries: int = 3, fault_hook=None,
                  step_timeout_s: float | None = None,
                  task: str = "inference", stepsize: float = 0.01,
                  decay: float = 0.95, **engine_kwargs):
    """Run ``engine.inference`` (or ``engine.learn`` with
    ``task="learning"``) of a ``GibbsEngine`` for ``epochs`` in
    checkpointed chunks, every chunk from the base ``seed`` at its
    first epoch's absolute index.

    Resumes from ``ckpt_path`` if it exists (elastic restart: the process
    can die and be relaunched with the same arguments), taking the base
    seed from the file. ``fault_hook`` (chunk_index -> None) may raise to
    simulate failures. Learning chunks continue the stepsize schedule:
    chunk c starts at ``stepsize * decay**epochs_done`` (reference
    learning loop factorgraph.py:190-204). Returns the final state.
    """
    done = 0
    device = state.device
    if os.path.exists(ckpt_path):
        state, seed, meta = load_checkpoint(ckpt_path, device)
        done = int(meta.get("epochs_done", 0))
        burn = 0 if done > 0 else burn
        metrics.add("resilience.resumes")

    chunk_index = done // max(chunk, 1)
    while done < epochs:
        n = min(chunk, epochs - done)
        retries = 0
        while True:
            try:
                if fault_hook is not None:
                    fault_hook(chunk_index)

                def _step():
                    if task == "learning":
                        out = engine.learn(
                            state, seed, epochs=n,
                            stepsize=stepsize * decay ** done,
                            decay=decay, burn=burn if done == 0 else 0,
                            epoch_offset=done, **engine_kwargs)
                    else:
                        out = engine.inference(
                            state, seed, epochs=n,
                            burn=burn if done == 0 else 0,
                            epoch_offset=done, **engine_kwargs)
                    _sync(out)
                    return out

                if step_timeout_s is not None:
                    new_state = call_with_timeout(_step, step_timeout_s)
                else:
                    new_state = _step()
                break
            except StallError:
                raise
            except Exception:
                retries += 1
                metrics.add("resilience.retries")
                if retries > max_retries:
                    raise
                if os.path.exists(ckpt_path):
                    state, seed, meta = load_checkpoint(ckpt_path, device)
                    done = int(meta.get("epochs_done", 0))
        state = new_state
        done += n
        chunk_index += 1
        save_checkpoint(ckpt_path, state, seed,
                        meta={"epochs_done": done})
        metrics.add("resilience.chunks")
        metrics.add("resilience.epochs", n)
    return state
