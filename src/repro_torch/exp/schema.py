"""Artifact validation: hydra-sweep/v3, hydra-serve/v1 and the
hydra-bench-* family (a copy of the JAX package's ``exp/schema.py``: the
port writes the same artifacts).

Dependency-free structural validator (the container has no jsonschema)
used by CI to gate the uploaded artifacts::

    python -m repro_torch.exp.schema sweep.json bench_sim.json [...]

Dispatches on each document's ``schema`` tag — ``hydra-sweep/v3`` rows
are validated in full (including the point's ``dram_kind`` tag that
distinguishes fluid from scheduled DRAM results); ``hydra-serve/v1``
trace-replay serving rows are validated in full (every row embeds its
``ServeSpec`` dump, so ``serve.ServeSpec.from_dict`` can re-run it);
``hydra-bench-*`` perf-trajectory artifacts (bench_lern.json,
bench_sim.json, bench_serve.json) get entry-level checks, with the
bench-sim and bench-serve entry shapes pinned exactly.  Exits non-zero
with a per-file error list on any violation.
"""
from __future__ import annotations

import json
import numbers
import sys
from typing import Dict, List

from .resultset import SWEEP_SCHEMA

_ROW_REQUIRED = ("name", "axes", "point", "metrics")
_POINT_REQUIRED = ("config", "mix", "policy", "params", "dram",
                   "dram_kind")


def validate_sweep(doc: Dict) -> List[str]:
    """All schema violations in ``doc`` (empty == valid hydra-sweep/v3)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") == "hydra-sweep/v2":
        errs.append("schema: hydra-sweep/v2 is rejected — v2 rows predate "
                    "the scheduled DRAM backends (no point.dram_kind); "
                    "re-run the sweep to regenerate a "
                    f"{SWEEP_SCHEMA} artifact")
    elif doc.get("schema") != SWEEP_SCHEMA:
        errs.append(f"schema: expected {SWEEP_SCHEMA!r}, "
                    f"got {doc.get('schema')!r}")
    keys = doc.get("keys")
    if not isinstance(keys, list) or not all(isinstance(k, str)
                                             for k in keys):
        errs.append("keys: expected a list of strings")
        keys = []
    rows = doc.get("rows")
    if not isinstance(rows, list):
        return errs + ["rows: expected a list"]
    for i, row in enumerate(rows):
        where = f"rows[{i}]"
        if not isinstance(row, dict):
            errs.append(f"{where}: not an object")
            continue
        for k in _ROW_REQUIRED:
            if k not in row:
                errs.append(f"{where}: missing required key {k!r}")
        name = row.get("name")
        if name is not None and not isinstance(name, str):
            errs.append(f"{where}.name: expected string or null")
        us = row.get("us_per_call")
        if us is not None and not isinstance(us, numbers.Real):
            errs.append(f"{where}.us_per_call: expected number or null")
        axes = row.get("axes")
        if not isinstance(axes, dict):
            errs.append(f"{where}.axes: expected an object")
        point = row.get("point")
        if point is not None:
            if not isinstance(point, dict):
                errs.append(f"{where}.point: expected object or null")
            else:
                for k in _POINT_REQUIRED:
                    if k not in point:
                        errs.append(f"{where}.point: missing {k!r}")
                kind = point.get("dram_kind")
                if kind is not None and not (
                        kind == "fluid"
                        or (isinstance(kind, str)
                            and kind.startswith("sched:"))):
                    errs.append(f"{where}.point.dram_kind: expected "
                                f"'fluid' or 'sched:<policy>', got {kind!r}")
        metrics = row.get("metrics")
        if not isinstance(metrics, dict) or not all(
                isinstance(v, numbers.Real) or v is None
                for v in metrics.values()):
            errs.append(f"{where}.metrics: expected an object of numbers")
        derived = row.get("derived")
        if derived is not None and not isinstance(derived, dict):
            errs.append(f"{where}.derived: expected object or null")
    return errs


# serve replay artifact (the JAX package's serve.to_serve_doc) — rows carry the
# coordinate axes, the per-row replay metrics and the full frozen
# ServeSpec dump (trace + resolved knobs), so any row is re-runnable via
# serve.ServeSpec.from_dict without the producing module
_SERVE_SCHEMA = "hydra-serve/v1"
_SERVE_POINT_REQUIRED = ("trace", "knobs", "slots", "max_steps",
                         "admission", "profile_sessions")


def validate_serve(doc: Dict) -> List[str]:
    """All schema violations in ``doc`` (empty == valid hydra-serve/v1)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != _SERVE_SCHEMA:
        errs.append(f"schema: expected {_SERVE_SCHEMA!r}, "
                    f"got {doc.get('schema')!r}")
    keys = doc.get("keys")
    if not isinstance(keys, list) or not all(isinstance(k, str)
                                             for k in keys):
        errs.append("keys: expected a list of strings")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        return errs + ["rows: expected a list"]
    for i, row in enumerate(rows):
        where = f"rows[{i}]"
        if not isinstance(row, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(row.get("axes"), dict):
            errs.append(f"{where}.axes: expected an object")
        eng = row.get("engine")
        if eng is not None and not isinstance(eng, str):
            errs.append(f"{where}.engine: expected string or null")
        point = row.get("point")
        if not isinstance(point, dict):
            errs.append(f"{where}.point: expected an object (the row's "
                        "ServeSpec dump)")
        else:
            for k in _SERVE_POINT_REQUIRED:
                if k not in point:
                    errs.append(f"{where}.point: missing {k!r}")
            for k in ("trace", "knobs"):
                if k in point and not isinstance(point[k], dict):
                    errs.append(f"{where}.point.{k}: expected an object")
        metrics = row.get("metrics")
        if not isinstance(metrics, dict) or not all(
                isinstance(v, numbers.Real) or v is None
                for v in metrics.values()):
            errs.append(f"{where}.metrics: expected an object of numbers")
    return errs


_BENCH_PREFIX = "hydra-bench-"
# bench-sim v3: entries are tagged by kind — "engine" rows carry the
# host-vs-fused epochs/sec pair, "sweep" rows the map-vs-bucketed
# points/sec pair (the whole-sweep device program the bucketed tentpole
# is gated on) plus the bucketed leg's per-phase split (stage /
# dispatch / device / write-back seconds), so a pps regression is
# attributable to one phase; v2 writers (no phase split) are rejected,
# as v2 rejected untagged v1
_BENCH_SIM_SCHEMA = "hydra-bench-sim/v3"
_BENCH_SIM_NUMERIC = ("lanes", "epochs", "host_s", "fused_s",
                      "host_eps", "fused_eps", "speedup")
_BENCH_SIM_SWEEP_NUMERIC = ("lanes", "points", "groups", "epochs",
                            "map_s", "bucketed_s", "map_pps",
                            "bucketed_pps", "pps_speedup",
                            "stage_s", "dispatch_s", "device_s",
                            "writeback_s")
# bench-lern v3: every entry carries the bucketed/segmented fit pair (the
# engine comparison the segmented k-means tentpole is gated on); v2-only
# writers (no pair) are rejected so the artifact gate stays honest
_BENCH_LERN_SCHEMA = "hydra-bench-lern/v3"
_BENCH_LERN_NUMERIC = ("host_s", "device_s", "bucketed_fit_s",
                       "segmented_fit_s", "speedup", "seg_speedup",
                       "accesses", "layers")
# bench-serve v1: sustained serving trajectory per (load point, knobs) —
# every entry carries the deterministic replay counters (the trend gate
# ratios ``sessions_per_kstep``, integer-derived and thus noise-free),
# plus wall_s for human eyes; hydra entries additionally carry
# ``resid_dmr_delta`` (evict-all DMR minus hydra DMR at the same load),
# the absolute floor asserting the residency rule buys real deadline
# headroom
_BENCH_SERVE_SCHEMA = "hydra-bench-serve/v1"
_BENCH_SERVE_NUMERIC = ("sessions", "slots", "rate", "steps",
                        "peak_concurrent", "sessions_per_kstep",
                        "p99_wait_steps", "dmr", "reprefills", "wall_s")


def validate_bench(doc: Dict) -> List[str]:
    """Violations in a ``hydra-bench-*`` perf-trajectory artifact."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    schema = doc.get("schema")
    if not isinstance(schema, str) or not schema.startswith(_BENCH_PREFIX):
        errs.append(f"schema: expected '{_BENCH_PREFIX}*', got {schema!r}")
        schema = ""
    if schema.startswith("hydra-bench-lern") and schema != _BENCH_LERN_SCHEMA:
        errs.append(f"schema: bench-lern writers must emit "
                    f"{_BENCH_LERN_SCHEMA!r} (got {schema!r}; v2-only "
                    "entries lack the bucketed/segmented fit pair)")
    if schema.startswith("hydra-bench-sim") and schema != _BENCH_SIM_SCHEMA:
        errs.append(f"schema: bench-sim writers must emit "
                    f"{_BENCH_SIM_SCHEMA!r} (got {schema!r}; v2 entries "
                    "lack the per-phase timing split on sweep rows)")
    if schema.startswith("hydra-bench-serve") \
            and schema != _BENCH_SERVE_SCHEMA:
        errs.append(f"schema: bench-serve writers must emit "
                    f"{_BENCH_SERVE_SCHEMA!r} (got {schema!r})")
    entries = doc.get("entries")
    if not isinstance(entries, list) or not entries:
        return errs + ["entries: expected a non-empty list"]
    is_sim = schema == _BENCH_SIM_SCHEMA
    is_lern = schema == _BENCH_LERN_SCHEMA
    is_serve = schema == _BENCH_SERVE_SCHEMA
    n_sweep = 0
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(e.get("config"), str):
            errs.append(f"{where}.config: expected string")
        bad_vals = [k for k, v in e.items()
                    if not isinstance(v, (str, numbers.Real))]
        if bad_vals:
            errs.append(f"{where}: non-scalar values for {bad_vals}")
        if is_sim:
            kind = e.get("kind")
            if kind not in ("engine", "sweep"):
                errs.append(f"{where}.kind: expected 'engine' or 'sweep', "
                            f"got {kind!r}")
                continue
            n_sweep += kind == "sweep"
            numeric = (_BENCH_SIM_SWEEP_NUMERIC if kind == "sweep"
                       else _BENCH_SIM_NUMERIC)
            for k in numeric:
                if not isinstance(e.get(k), numbers.Real):
                    errs.append(f"{where}.{k}: expected a number")
            if not isinstance(e.get("mix"), str):
                errs.append(f"{where}.mix: expected string")
        if is_lern:
            for k in _BENCH_LERN_NUMERIC:
                if not isinstance(e.get(k), numbers.Real):
                    errs.append(f"{where}.{k}: expected a number")
        if is_serve:
            for k in _BENCH_SERVE_NUMERIC:
                if not isinstance(e.get(k), numbers.Real):
                    errs.append(f"{where}.{k}: expected a number")
            if not isinstance(e.get("knobs"), str):
                errs.append(f"{where}.knobs: expected string")
    if is_sim and not n_sweep:
        errs.append("entries: bench-sim/v3 requires at least one "
                    "kind='sweep' points/sec entry")
    return errs


_MANIFEST_SCHEMA = "hydra-manifest/v1"
# "dedup" marks a serve.run cell served from the in-process memo (an
# identical spec earlier in the same run)
_POINT_SOURCES = ("computed", "cache", "resume", "dedup")


def validate_manifest(doc: Dict) -> List[str]:
    """Violations in a ``hydra-manifest/v1`` incremental sweep manifest
    (faults.RunReport.to_doc)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != _MANIFEST_SCHEMA:
        errs.append(f"schema: expected {_MANIFEST_SCHEMA!r}, "
                    f"got {doc.get('schema')!r}")
    n = doc.get("n_points")
    if n is not None and not isinstance(n, numbers.Integral):
        errs.append("n_points: expected integer or null")
    completed = doc.get("completed")
    if not isinstance(completed, dict):
        errs.append("completed: expected an object")
    else:
        for key, rec in completed.items():
            where = f"completed[{key!r}]"
            if not isinstance(rec, dict):
                errs.append(f"{where}: not an object")
                continue
            src = rec.get("source")
            if src not in _POINT_SOURCES:
                errs.append(f"{where}.source: expected one of "
                            f"{_POINT_SOURCES}, got {src!r}")
            eng = rec.get("engine")
            if eng is not None and not isinstance(eng, str):
                errs.append(f"{where}.engine: expected string or null")
    events = doc.get("events")
    if not isinstance(events, list):
        errs.append("events: expected a list")
    else:
        for i, ev in enumerate(events):
            if not isinstance(ev, dict) or not isinstance(ev.get("kind"),
                                                          str):
                errs.append(f"events[{i}]: expected an object with a "
                            "string 'kind'")
    return errs


def validate(doc: Dict) -> List[str]:
    """Dispatch on the document's schema tag."""
    schema = doc.get("schema") if isinstance(doc, dict) else None
    if isinstance(schema, str) and schema.startswith(_BENCH_PREFIX):
        return validate_bench(doc)
    if schema == _MANIFEST_SCHEMA:
        return validate_manifest(doc)
    if schema == _SERVE_SCHEMA:
        return validate_serve(doc)
    return validate_sweep(doc)


def main(argv: List[str]) -> int:
    if not argv:
        print("usage: python -m repro_torch.exp.schema sweep.json "
              "[bench_sim.json ...]")
        return 2
    bad = 0
    for path in argv:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable ({e})")
            bad += 1
            continue
        errs = validate(doc)
        if errs:
            bad += 1
            print(f"{path}: INVALID ({len(errs)} errors)")
            for e in errs[:20]:
                print(f"  - {e}")
        else:
            n = len(doc.get("rows", doc.get("entries", [])))
            print(f"{path}: ok ({n} rows, schema {doc['schema']})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
