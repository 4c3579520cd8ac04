"""Columnar, queryable result container + the sweep.json v3 schema (a
copy of the JAX package's ``exp/resultset.py``; the port writes the same
artifact).

A :class:`ResultSet` holds one row per evaluated (or derived) cell as
parallel columns.  ``keys`` names the coordinate columns (the spec's
axes); everything numeric outside the keys is a metric.  Query helpers
(``filter`` / ``group_by`` / ``mean_over``) return new ResultSets, so a
figure module is a handful of declarative reads over one batched run
instead of a bespoke accumulation loop.

Serialization is the versioned **hydra-sweep/v3** artifact: every row
embeds its full point spec (policy/params dataclass dumps, config and
dram names), so a row is interpretable — and re-runnable — without the
module context that produced it.  v3 point specs additionally carry
``dram_kind`` ("fluid" or "sched:<policy>"), distinguishing results
produced by the scheduled bank/rank DRAM backend from the fluid
queueing models — two runs with the same model *name* are not
comparable across that boundary.  v2 rows (no ``dram_kind``) and v1
rows (only ``name/us_per_call/derived``) are rejected on read.
"""
from __future__ import annotations

import json
import numbers
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

SWEEP_SCHEMA = "hydra-sweep/v3"

# columns with artifact-level meaning (everything else is keys or metrics)
_SPECIAL = ("name", "us_per_call", "derived", "point", "result")


def _is_num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


class ResultSet:
    """Columnar rows with named key (coordinate) columns."""

    def __init__(self, columns: Dict[str, list],
                 keys: Sequence[str] = ()):
        lens = {len(v) for v in columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self._cols: Dict[str, list] = {k: list(v) for k, v in columns.items()}
        self.keys: Tuple[str, ...] = tuple(k for k in keys if k in self._cols)
        # structured execution record (faults.RunReport) —
        # attached by exp.run; summarized into the sweep doc header
        self.run_report = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_records(cls, records: Sequence[Dict],
                     keys: Sequence[str] = ()) -> "ResultSet":
        names: List[str] = []
        for r in records:
            for k in r:
                if k not in names:
                    names.append(k)
        cols = {k: [r.get(k) for r in records] for k in names}
        return cls(cols, keys=keys)

    # -- basics --------------------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self._cols.values()), []))

    def columns(self) -> List[str]:
        return list(self._cols)

    def column(self, name: str) -> list:
        return list(self._cols[name])

    def to_rows(self) -> List[Dict]:
        names = list(self._cols)
        return [{k: self._cols[k][i] for k in names}
                for i in range(len(self))]

    def __iter__(self):
        return iter(self.to_rows())

    def one(self) -> Dict:
        if len(self) != 1:
            raise ValueError(f"expected exactly one row, have {len(self)}")
        return self.to_rows()[0]

    def results(self) -> list:
        """The raw SimResult objects (full histories/occupancy), when this
        set came from ``exp.run``."""
        return self.column("result")

    def metrics(self) -> List[str]:
        return [k for k in self._cols
                if k not in self.keys and k not in _SPECIAL
                and any(_is_num(v) for v in self._cols[k])]

    # -- queries -------------------------------------------------------------
    def _take(self, idx: Sequence[int]) -> "ResultSet":
        return ResultSet({k: [v[i] for i in idx]
                          for k, v in self._cols.items()}, keys=self.keys)

    def filter(self, pred: Optional[Callable[[Dict], bool]] = None,
               **eq) -> "ResultSet":
        """Rows matching all ``column=value`` equalities (and ``pred`` if
        given)."""
        rows = self.to_rows()
        idx = [i for i, r in enumerate(rows)
               if all(r.get(k) == v for k, v in eq.items())
               and (pred is None or pred(r))]
        return self._take(idx)

    def group_by(self, *names: str) -> Dict[tuple, "ResultSet"]:
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(self)):
            key = tuple(self._cols[n][i] for n in names)
            groups.setdefault(key, []).append(i)
        return {k: self._take(idx) for k, idx in groups.items()}

    def mean_over(self, axis: str,
                  metrics: Optional[Sequence[str]] = None) -> "ResultSet":
        """Average the metric columns over ``axis``, grouping by the
        remaining key columns — ``rs.mean_over("mix")`` is one paper bar
        per (config, policy, ...) cell."""
        if axis not in self._cols:
            raise KeyError(f"no column {axis!r} (have {list(self._cols)})")
        mets = list(metrics) if metrics is not None else self.metrics()
        rest = [k for k in self.keys if k != axis]
        out: List[Dict] = []
        for key, grp in self.group_by(*rest).items():
            row = dict(zip(rest, key))
            row["n"] = len(grp)
            for m in mets:
                vals = [v for v in grp._cols.get(m, []) if _is_num(v)]
                row[m] = float(sum(vals)) / len(vals) if vals else None
            out.append(row)
        return ResultSet.from_records(out, keys=rest)

    # -- serialization (hydra-sweep/v3) --------------------------------------
    def to_sweep_doc(self, **header) -> Dict:
        """The versioned sweep.json v3 document: header + one embedded-spec
        row per result."""
        rows = []
        for r in self.to_rows():
            point = r.get("point")
            if point is not None and hasattr(point, "spec_dict"):
                point = point.spec_dict()
            row = {
                "name": r.get("name"),
                "us_per_call": r.get("us_per_call"),
                "axes": {k: r.get(k) for k in self.keys},
                "point": point,
                "metrics": {k: r[k] for k in self._cols
                            if k not in self.keys and k not in _SPECIAL
                            and _is_num(r.get(k))},
                "derived": r.get("derived"),
            }
            rows.append(row)
        doc = {"schema": SWEEP_SCHEMA, "keys": list(self.keys)}
        if self.run_report is not None:
            doc["run_report"] = self.run_report.summary()
        doc.update(header)
        doc["rows"] = rows
        return doc

    def to_sweep_json(self, path: str, **header) -> Dict:
        doc = self.to_sweep_doc(**header)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return doc

    @classmethod
    def from_sweep_doc(cls, doc: Dict) -> "ResultSet":
        if doc.get("schema") == "hydra-sweep/v2":
            raise ValueError(
                "hydra-sweep/v2 artifact: v2 rows predate the scheduled "
                "DRAM backends (no point.dram_kind), so fluid and "
                "scheduled results are indistinguishable; re-run the "
                f"sweep to regenerate a {SWEEP_SCHEMA} artifact")
        if doc.get("schema") != SWEEP_SCHEMA:
            raise ValueError(f"expected schema {SWEEP_SCHEMA!r}, "
                             f"got {doc.get('schema')!r}")
        keys = list(doc.get("keys", []))
        records = []
        for row in doc["rows"]:
            rec = dict(row.get("axes") or {})
            rec.update(row.get("metrics") or {})
            for k in ("name", "us_per_call", "derived", "point"):
                if row.get(k) is not None:
                    rec[k] = row[k]
            records.append(rec)
        return cls.from_records(records, keys=keys)

    @classmethod
    def from_sweep_json(cls, path: str) -> "ResultSet":
        with open(path) as f:
            return cls.from_sweep_doc(json.load(f))

    def __repr__(self) -> str:
        return (f"ResultSet({len(self)} rows, keys={list(self.keys)}, "
                f"metrics={self.metrics()})")
