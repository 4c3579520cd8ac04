"""Uniform registries behind the declarative experiment API.

Every axis a spec can name — policies, workload configs, DRAM models,
SimParams presets — resolves through a :class:`Registry` with one
protocol: ``register`` / ``get`` / ``names`` / ``__contains__``.  The
policy and workload registries are *views over the existing core dicts*
(``policies.POLICIES``, ``workloads.CONFIGS``): registering through
either side is visible to both, so nothing in core had to move and
``sim.load_trace`` keeps resolving registry-registered drift variants.

``quick`` / ``full`` / ``smoke`` are frozen ``SimParams`` presets derived
with ``dataclasses.replace``, the JAX package's values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Generic, Iterator, List, Optional, TypeVar

from ..core import dram as dram_mod
from ..core import policies as policies_mod
from ..core import workloads as workloads_mod
from ..core.sim import SimParams

T = TypeVar("T")


class Registry(Generic[T]):
    """Name -> entry mapping with a uniform register/get/names protocol.

    ``backing`` lets a registry wrap a pre-existing module-level dict
    (shared mutable state by design: both views must see registrations).
    ``validate`` runs on every registered entry and may normalize it.
    """

    def __init__(self, kind: str,
                 backing: Optional[Dict[str, T]] = None,
                 validate: Optional[Callable[[str, T], T]] = None):
        self.kind = kind
        self._entries: Dict[str, T] = backing if backing is not None else {}
        self._validate = validate

    def register(self, name: str, entry: T, *, overwrite: bool = False) -> T:
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} registry: name must be a "
                             f"non-empty string, got {name!r}")
        if self._validate is not None:
            entry = self._validate(name, entry)
        if not overwrite and name in self._entries \
                and self._entries[name] != entry:
            raise ValueError(f"{self.kind} registry: {name!r} already "
                             "registered with different contents "
                             "(pass overwrite=True to replace)")
        self._entries[name] = entry
        return entry

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(self.names()[:12])
            raise KeyError(f"unknown {self.kind} {name!r} "
                           f"(known: {known}, ...)") from None

    def names(self) -> List[str]:
        return sorted(self._entries)

    def items(self):
        return [(k, self._entries[k]) for k in self.names()]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {len(self)} entries)"


def _check_policy(name: str, p) -> "policies_mod.Policy":
    if not isinstance(p, policies_mod.Policy):
        raise TypeError(f"policy {name!r}: expected Policy, got {type(p)}")
    return p


def _check_workload(name: str, c) -> "workloads_mod.AccelConfig":
    if not isinstance(c, workloads_mod.AccelConfig):
        raise TypeError(f"workload {name!r}: expected AccelConfig, "
                        f"got {type(c)}")
    return c


def _check_dram(name: str, d) -> "dram_mod.DramModel":
    if not isinstance(d, dram_mod.DramModel):
        raise TypeError(f"dram {name!r}: expected DramModel, got {type(d)}")
    return d


def _check_params(name: str, p) -> SimParams:
    if not isinstance(p, SimParams):
        raise TypeError(f"params {name!r}: expected SimParams, got {type(p)}")
    return p


def _check_knobs(name: str, k):
    # lazy: serve.knobs imports this module to register its presets, so
    # the class can only be named here at validation time
    from ..serve.knobs import SchedulerKnobs
    if not isinstance(k, SchedulerKnobs):
        raise TypeError(f"serve {name!r}: expected SchedulerKnobs, "
                        f"got {type(k)}")
    return k


POLICIES: Registry = Registry("policy", backing=policies_mod.POLICIES,
                              validate=_check_policy)
WORKLOADS: Registry = Registry("workload", backing=workloads_mod.CONFIGS,
                               validate=_check_workload)
DRAM: Registry = Registry("dram", backing=dram_mod.MODELS,
                          validate=_check_dram)
PARAMS: Registry = Registry("params", validate=_check_params)
# serve-side residency policies (SchedulerKnobs presets).  The entries
# are registered by ``serve.knobs`` on import -- ``exp`` imports it last
# thing, so the registry is populated either way the packages are first
# reached.
SERVE: Registry = Registry("serve", validate=_check_knobs)

# SimParams presets.  ``quick``/``full`` share the benchmark suite's
# BASE_PARAMS values (the quick/full difference is the mix and config
# *sets*, not the params); ``smoke`` is the CI footprint.
_BASE = SimParams(n_inputs=3, max_epochs=1500)
PARAMS.register("default", SimParams())
PARAMS.register("quick", _BASE)
PARAMS.register("full", _BASE)
PARAMS.register("smoke", dataclasses.replace(
    _BASE, n_inputs=1, max_epochs=60, subsample_target=50_000))

REGISTRIES: Dict[str, Registry] = {
    "policy": POLICIES, "workload": WORKLOADS,
    "dram": DRAM, "params": PARAMS, "serve": SERVE,
}
