"""Declarative experiment specs.

A :class:`Point` is one frozen, hashable cell of the paper's evaluation
cross-product — (workload config, core mix, policy, SimParams, DRAM
model) — and an :class:`ExperimentSpec` is a named-axis cross-product of
them.  Figure modules describe *what* to evaluate with a spec; the
engine-level *how* (lane batching, disk caching) stays in
``repro_torch.core.sweep`` and is reached through ``repro_torch.exp.run``.

Axis values may be registry names (``"hydra"``, ``"config3"``,
``"smoke"``, ``"DDR4_2400_8x8"``) or the resolved objects themselves.
Policy axis values additionally accept ``(base, *transforms)`` tuples,
where the transforms are the spec-level forms of the old
``policies.with_online`` / ``with_way_partition`` / ``with_lrpt``
derivers (plus APM field overrides for the §VI-L sensitivity table)::

    ExperimentSpec.grid(config="config1", mix=["moti1", "mix3"],
                        policy=["fifo-nb", ("hydra", online(50))],
                        params="quick")

Any extra keyword axis whose name is a ``SimParams`` field becomes a
per-point params override (e.g. ``llc_size_bytes=[...]`` for the Fig. 16
capacity sweep), so per-figure variation is a named axis instead of a
hand-rolled ``dataclasses.replace`` loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

from ..core import policies as policies_mod
from ..core import sweep as sweep_mod
from ..core.dram import DramModel, default_model, dram_kind
from ..core.policies import Policy
from ..core.sim import SimParams, result_cache_path
from ..core.workloads import AccelConfig

from .registry import DRAM, PARAMS, POLICIES, WORKLOADS

_PARAM_FIELDS = frozenset(f.name for f in dataclasses.fields(SimParams))
_CANONICAL = ("config", "mix", "policy", "params", "dram")


# ---------------------------------------------------------------------------
# policy transforms (spec-level derivers)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class online:
    """``<name>-ol``: refit LERN every ``period`` epochs during the run."""
    period: float = policies_mod.DEFAULT_RETRAIN_PERIOD

    def __call__(self, p: Policy) -> Policy:
        return policies_mod.with_online(p, self.period)


@dataclasses.dataclass(frozen=True)
class way_partition:
    """``<name>-wp``: static core/accel way masks."""
    core_mask: int
    accel_mask: int

    def __call__(self, p: Policy) -> Policy:
        return policies_mod.with_way_partition(p, self.core_mask,
                                               self.accel_mask)


@dataclasses.dataclass(frozen=True)
class lrpt:
    """``<name>-<variant>``: hardware-optimized L-RPT variant (§VI-J)."""
    variant: str

    def __call__(self, p: Policy) -> Policy:
        return policies_mod.with_lrpt(p, self.variant)


@dataclasses.dataclass(frozen=True)
class _ApmOverride:
    fields: Tuple[Tuple[str, float], ...]

    def __call__(self, p: Policy) -> Policy:
        suffix = "-".join(f"{k}{v:g}" for k, v in self.fields)
        return dataclasses.replace(
            p, name=f"{p.name}-{suffix}",
            apm=dataclasses.replace(p.apm, **dict(self.fields)))


def with_apm(**fields: float) -> _ApmOverride:
    """APM parameter override (the §VI-L sensitivity axes)."""
    return _ApmOverride(tuple(sorted(fields.items())))


PolicyLike = Union[str, Policy, tuple]


def resolve_policy(v: PolicyLike) -> Policy:
    if isinstance(v, Policy):
        return v
    if isinstance(v, str):
        return POLICIES.get(v)
    if isinstance(v, tuple) and v:
        p = resolve_policy(v[0])
        for t in v[1:]:
            p = t(p)
        return p
    raise TypeError(f"cannot resolve policy from {v!r}")


def resolve_config(v: Union[str, AccelConfig]) -> str:
    if isinstance(v, AccelConfig):
        # unconditional: re-registering an equal config is a no-op, and a
        # *different* config under a taken name must raise, not silently
        # evaluate whatever that name already resolves to
        WORKLOADS.register(v.name, v)
        return v.name
    WORKLOADS.get(v)  # raise early with the registry's message
    return v


def resolve_params(v: Union[str, SimParams]) -> SimParams:
    return PARAMS.get(v) if isinstance(v, str) else v


def resolve_dram(v: Union[str, DramModel]) -> DramModel:
    return DRAM.get(v) if isinstance(v, str) else v


# ---------------------------------------------------------------------------
# Point
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Point:
    """One fully-resolved evaluation cell.  Frozen and hashable — usable
    as a dict key, dedup key, or set member."""
    config: str
    mix: str
    policy: Policy
    params: SimParams
    dram: DramModel

    def sweep_point(self) -> sweep_mod.SweepPoint:
        return sweep_mod.SweepPoint(self.config, self.mix, self.policy,
                                    self.params, self.dram)

    def cache_path(self) -> str:
        """Disk-cache location of this point (``sim.result_cache_path``)
        — every engine dedups through this one key space."""
        return result_cache_path(self.config, self.mix, self.policy,
                                 self.params, self.dram)

    def spec_dict(self) -> Dict:
        """JSON-able embedded point spec (sweep.json v3 rows carry this so
        a row is interpretable without the producing module's context —
        ``dram_kind`` distinguishes the fluid queueing models from the
        scheduled bank/rank backends, which a plain model name cannot)."""
        return {"config": self.config, "mix": self.mix,
                "policy": dataclasses.asdict(self.policy),
                "params": dataclasses.asdict(self.params),
                "dram": self.dram.name,
                "dram_kind": dram_kind(self.dram)}


# ---------------------------------------------------------------------------
# ExperimentSpec
# ---------------------------------------------------------------------------
def _tup(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Named axes whose cross-product is the experiment."""
    axes: Tuple[Tuple[str, tuple], ...]

    @classmethod
    def grid(cls, *, config="config1", mix="moti1", policy="fifo-nb",
             params="default", dram=None,
             **extra) -> "ExperimentSpec":
        """Build a spec from scalar-or-list axis values.

        ``dram=None`` (default) resolves through ``dram.default_model``
        (honors the ``REPRO_DRAM`` env override).  Extra keyword axes
        must name ``SimParams`` fields; they become per-point overrides
        of the resolved params."""
        if dram is None:
            dram = default_model().name
        axes = [("config", _tup(config)), ("mix", _tup(mix)),
                ("policy", _tup(policy)), ("params", _tup(params)),
                ("dram", _tup(dram))]
        for k, v in extra.items():
            if k not in _PARAM_FIELDS:
                raise ValueError(
                    f"unknown axis {k!r}: extra axes must be SimParams "
                    f"fields ({sorted(_PARAM_FIELDS)})")
            axes.append((k, _tup(v)))
        return cls(tuple(axes))

    def product(self, **axes) -> "ExperimentSpec":
        """Extend (or re-bind) named axes, returning a new spec:
        ``spec.product(llc_size_bytes=[...])`` crosses every existing
        point with the new axis."""
        names = [n for n, _ in self.axes]
        out = list(self.axes)
        for k, v in axes.items():
            if k not in _CANONICAL and k not in _PARAM_FIELDS:
                raise ValueError(f"unknown axis {k!r}")
            if k in names:
                out[names.index(k)] = (k, _tup(v))
            else:
                out.append((k, _tup(v)))
        return ExperimentSpec(tuple(out))

    def axis(self, name: str) -> tuple:
        for n, vals in self.axes:
            if n == name:
                return vals
        raise KeyError(name)

    def __len__(self) -> int:
        n = 1
        for _, vals in self.axes:
            n *= len(vals)
        return n

    def expand(self) -> List[Tuple[Point, Dict]]:
        """Cross-product -> [(Point, axis-value row), ...].

        The axis-value row holds JSON-scalar coordinates (policy/config/
        dram names, params preset label, raw override values) — these
        become the key columns of the ResultSet."""
        import itertools
        names = [n for n, _ in self.axes]
        out: List[Tuple[Point, Dict]] = []
        for combo in itertools.product(*(vals for _, vals in self.axes)):
            bound = dict(zip(names, combo))
            config = resolve_config(bound["config"])
            policy = resolve_policy(bound["policy"])
            params = resolve_params(bound["params"])
            dram = resolve_dram(bound["dram"])
            overrides = {k: v for k, v in bound.items()
                         if k not in _CANONICAL}
            if overrides:
                params = dataclasses.replace(params, **overrides)
            pt = Point(config=config, mix=bound["mix"], policy=policy,
                       params=params, dram=dram)
            row = {"config": config, "mix": bound["mix"],
                   "policy": policy.name,
                   "params": (bound["params"]
                              if isinstance(bound["params"], str)
                              else "custom"),
                   "dram": dram.name, **overrides}
            out.append((pt, row))
        return out

    def points(self) -> List[Point]:
        return [pt for pt, _ in self.expand()]
