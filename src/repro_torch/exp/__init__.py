"""Declarative experiment API of the port -- the public way to run it.

    from repro_torch import exp

    spec = exp.ExperimentSpec.grid(
        config="config3", mix="moti2",
        policy=["fifo-nb", "arp-nb", "hydra"], params="full")
    rs = exp.run(spec, plan=exp.ExecPlan(engine="host"), device="cuda")
    for row in rs.to_rows():
        print(row["policy"], row["ipc"], row["dmr"])

The JAX package's ``repro.exp``, ported: frozen :class:`ExperimentSpec`/
:class:`Point` cell descriptions, a frozen :class:`ExecPlan` (env vars
are its defaults), five uniform registries, and :func:`run` -> columnar
:class:`ResultSet` (hydra-sweep/v3 serialization).  The engines
underneath live in ``repro_torch.core.sweep``; ``run`` takes ``device=``
and defaults to the card.
"""
from .faults import FaultPlan, FaultSpec, InjectedFault, RunReport
from .plan import ExecPlan
from .registry import (DRAM, PARAMS, POLICIES, REGISTRIES, SERVE, WORKLOADS,
                       Registry)
from .resultset import SWEEP_SCHEMA, ResultSet
from .runner import run, run_points
from .spec import (ExperimentSpec, Point, lrpt, online, resolve_policy,
                   way_partition, with_apm)

# populate the serve registry (serve.knobs registers its presets on
# import; kept last so every submodule above is fully bound first)
from ..serve import knobs as _serve_knobs  # noqa: E402,F401

# (the hydra-sweep/v3 validator lives in exp.schema, deliberately not
# imported here so `python -m repro_torch.exp.schema` runs without a
# runpy warning)

__all__ = [
    "ExecPlan", "ExperimentSpec", "Point", "ResultSet", "Registry",
    "run", "run_points",
    "POLICIES", "WORKLOADS", "DRAM", "PARAMS", "SERVE", "REGISTRIES",
    "online", "way_partition", "lrpt", "with_apm", "resolve_policy",
    "SWEEP_SCHEMA",
    "FaultPlan", "FaultSpec", "InjectedFault", "RunReport",
]
