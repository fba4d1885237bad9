"""State converter between the JAX package's pytrees and the port's types.

The engine has no learned weights; what carries across is state. The
JAX ``Window`` / ``Bank`` / ``TrackerRef`` come in as numpy arrays (one
``np.asarray`` per field, per level for ``TrackerRef``) and leave as
numpy arrays, so neither package imports the other.

Stored integer state stays int32 and masks stay bool, as in the
reference; every float field becomes float32.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from ldso_tpu_torch.core.bank import Bank
from ldso_tpu_torch.core.window import Window
from ldso_tpu_torch.tracker import TrackerRef

KINDS = {"window": Window, "bank": Bank, "tracker_ref": TrackerRef}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.bool_:
        a = a.astype(np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32)
    return torch.tensor(a, device=device)       # a copy: inputs may be read-only


def _fields(arrays) -> Mapping:
    if isinstance(arrays, Mapping):
        return arrays
    return {f: getattr(arrays, f) for f in arrays._fields}


def from_numpy(kind: str, arrays, *, device) -> Union[Window, Bank, TrackerRef]:
    """Build the port's ``kind`` ("window", "bank" or "tracker_ref") from a
    mapping or NamedTuple of numpy arrays with the reference's field names."""
    cls = KINDS[kind]
    src = _fields(arrays)
    out = {}
    for f in cls._fields:
        v = src[f]
        if isinstance(v, (tuple, list)):
            out[f] = tuple(_to_tensor(a, device) for a in v)
        else:
            out[f] = _to_tensor(v, device)
    return cls(**out)


def to_numpy(state) -> dict:
    """Port state (Window / Bank / TrackerRef) -> dict of numpy arrays
    (tuples of arrays for per-level fields)."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        out[f] = (tuple(a.cpu().numpy() for a in v) if isinstance(v, tuple)
                  else v.cpu().numpy())
    return out
