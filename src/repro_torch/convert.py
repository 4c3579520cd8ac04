"""State carried across from the JAX package, given as numpy arrays.

The parity tests feed the port the reference's trained LERN model and
mid-run LLC state through these, so the LLC engine and the host loop are
held to the reference apart from the k-means fit.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import device as _device
from .core.lern import LernModel
from .core.llc import LLCState
from .core.lrpt import lrpt_train_hash


def lern_model_from_numpy(uniq: np.ndarray, rc_cluster: np.ndarray,
                          ri_cluster: np.ndarray, n_uniq: np.ndarray,
                          rc_centers: np.ndarray, ri_centers: np.ndarray,
                          features_ri: List[np.ndarray],
                          lrpt_variant: str = "full") -> LernModel:
    """The port's ``LernModel`` from the fields of a reference
    ``LernModel``.  Its training hash is rebuilt from ``lrpt_variant``
    (the reference's hash object belongs to the JAX package)."""
    return LernModel(
        uniq=np.asarray(uniq, np.int64),
        rc_cluster=np.asarray(rc_cluster, np.int8),
        ri_cluster=np.asarray(ri_cluster, np.int8),
        n_uniq=np.asarray(n_uniq, np.int32),
        rc_centers=np.asarray(rc_centers, np.float32),
        ri_centers=np.asarray(ri_centers, np.float32),
        features_ri=[np.asarray(f, np.int64) for f in features_ri],
        hash_fn=lrpt_train_hash(lrpt_variant))


def llc_state_from_numpy(tags, lru, owner, sig, reused, tick, shct_core,
                         shct_accel, device="cuda") -> LLCState:
    """The port's ``LLCState`` on ``device`` from the eight arrays of a
    reference ``LLCState``."""
    dev = _device.resolve(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return LLCState(tags=t(tags), lru=t(lru), owner=t(owner), sig=t(sig),
                    reused=t(reused, torch.bool), tick=t(tick),
                    shct_core=t(shct_core), shct_accel=t(shct_accel))
