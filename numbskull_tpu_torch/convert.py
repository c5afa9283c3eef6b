"""Carry a compiled graph and sampler state over from the JAX package.

The two packages share no classes (the port cannot import the JAX
package, whose import pulls in jax), so state crosses as plain numpy:
``dataclasses.asdict`` of the JAX ``CompiledGraph`` (nested ``ColorPlan``
dicts included), and the sampler state's arrays. With these, one compile
can feed both packages and their outputs can be compared array by array.
"""

from __future__ import annotations

import numpy as np
import torch

from numbskull_tpu_torch.compile import ColorPlan, CompiledGraph
from numbskull_tpu_torch.ops.gibbs import SamplerState
from numbskull_tpu_torch.ops.stencil import GridState
from numbskull_tpu_torch.parallel.bsp import BSPState


def compiled_graph_from_reference(fields: dict) -> CompiledGraph:
    """The port's CompiledGraph from ``dataclasses.asdict`` of the JAX
    package's; every array is copied."""
    fields = dict(fields)
    plans = [ColorPlan(**{k: np.array(v) if isinstance(v, np.ndarray)
                          else v for k, v in p.items()})
             for p in fields.pop("plans")]
    rest = {k: np.array(v) if isinstance(v, np.ndarray) else v
            for k, v in fields.items()}
    return CompiledGraph(plans=plans, **rest)


def sampler_state_from_reference(var_value, var_value_evid, weight_value,
                                 count, device) -> SamplerState:
    """The port's SamplerState on ``device`` from the JAX state's arrays
    (numpy, or anything ``np.asarray`` reads)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return SamplerState(var_value=t(var_value, np.int32),
                        var_value_evid=t(var_value_evid, np.int32),
                        weight_value=t(weight_value, np.float32),
                        count=t(count, np.int32))


def grid_state_from_reference(x, count, device):
    """The port's GridState on ``device`` from a JAX ``GridState``'s
    arrays (``x`` and ``count``, as numpy or anything ``np.asarray``
    reads)."""
    return GridState(
        x=torch.as_tensor(np.array(x, dtype=np.int32), device=device),
        count=torch.as_tensor(np.array(count, dtype=np.int32),
                              device=device))


def bsp_state_from_reference(values, values_evid, weights, counts,
                             device) -> BSPState:
    """The global state of a ``parallel/bsp.BSPItemGridInference`` on
    ``device`` from a JAX ``BSPItemGridInference``'s ``_values``,
    ``_values_evid``, ``_weights`` and ``_counts`` (assign it to the
    port engine's ``state`` to continue the run)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return BSPState(values=t(values, np.int32),
                    values_evid=t(values_evid, np.int32),
                    weights=t(weights, np.float32),
                    counts=t(counts, np.int64))
