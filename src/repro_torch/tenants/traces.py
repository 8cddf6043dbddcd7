"""Real-workflow trace importers: Pegasus DAX XML and WfCommons JSON.

Parses workflow descriptions from the two community formats into
:class:`core.types.Workflow`:

* **Pegasus DAX** (``<adag>`` with ``<job runtime=...>`` elements carrying
  ``<uses file=... link=input|output size=bytes/>`` and a
  ``<child><parent/></child>`` dependency section) — the format behind the
  Pegasus workflow gallery the paper's Table 1 profiles;
* **WfCommons JSON** (``workflow.tasks`` / legacy ``workflow.jobs`` arrays
  with per-task ``runtime`` seconds, ``parents`` name lists and ``files``
  size records) — the successor trace archive.

Units: traced runtime **seconds → MI** via the per-family reference-host
calibration in :mod:`repro_torch.workflows.dax` (``TRACE_CALIBRATION``), file
**bytes → MB** scaled by the family's I/O class.  A task's ``out_mb`` is
the sum of its output file sizes (children read it as their input, exactly
like the synthetic generators); input files no task produces are staged
from global storage as ``ext_in_mb``.

Importers are **pure functions of the bytes**: no RNG, document order
preserved, every workflow passed through ``Workflow.validate`` — the same
bytes always yield an identical ``Workflow`` (gated by
``tests/test_tenants.py``), and malformed traces (cycles, dangling
parents, empty DAGs) are rejected at load time with a clear
``ValueError``, never mid-simulation.

Three small real-shaped traces are bundled under ``tenants/data/`` for
tests, docs and the ``online-*`` scenario families.
"""
from __future__ import annotations

import json
import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple, Union

from ..core.types import Task, Workflow
from ..workflows.dax import (TRACE_FAMILY_HINTS, TraceCalibration,
                             trace_calibration)

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

Source = Union[str, bytes, os.PathLike]


def infer_family(name: str) -> Optional[str]:
    """Map a trace / namespace / application name onto a Table-1 family."""
    low = name.lower()
    for hint, family in TRACE_FAMILY_HINTS.items():
        if hint in low:
            return family
    return None


def _read(source: Source) -> bytes:
    """Accept raw bytes, an XML/JSON string, or a filesystem path."""
    if isinstance(source, bytes):
        return source
    if isinstance(source, str) and source.lstrip()[:1] in ("<", "{"):
        return source.encode("utf-8")
    with open(source, "rb") as f:
        return f.read()


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _finite_nonneg(x, what: str, name: str, tname: str) -> float:
    """Parse a runtime / file size field from a hostile trace: must be
    numeric, finite and non-negative — NaN runtimes would otherwise
    propagate into task sizes and poison every cost estimate
    downstream, silently."""
    try:
        v = float(x)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"trace {name!r}: task {tname!r} has non-numeric {what} "
            f"({x!r})") from e
    if math.isnan(v) or math.isinf(v):
        raise ValueError(
            f"trace {name!r}: task {tname!r} has non-finite {what} ({v!r})")
    if v < 0.0:
        raise ValueError(
            f"trace {name!r}: task {tname!r} has negative {what} ({v})")
    return v


def _finish(name: str, app: Optional[str], specs: List[dict],
            edges: List[Tuple[int, int]]) -> Workflow:
    """Assemble tasks + edges into a validated, calibrated Workflow."""
    if not specs:
        raise ValueError(f"trace {name!r}: no tasks found")
    family = infer_family(app or name)
    cal: TraceCalibration = trace_calibration(family or "")
    tasks = [
        Task(tid=i,
             size_mi=s["runtime_s"] * cal.mips,
             out_mb=s["out_mb"] * cal.mb_scale,
             ext_in_mb=s["ext_mb"] * cal.mb_scale)
        for i, s in enumerate(specs)
    ]
    for u, v in edges:
        tasks[u].children.append(v)
        tasks[v].parents.append(u)
    wf = Workflow(wid=0, app=app or family or name, tasks=tasks)
    wf.validate()
    return wf


# ---------------------------------------------------------------------------
# Pegasus DAX XML
# ---------------------------------------------------------------------------


def load_dax(source: Source, name: str = "dax") -> Workflow:
    """Parse a Pegasus DAX XML document into a Workflow."""
    try:
        root = ET.fromstring(_read(source))
    except ET.ParseError as e:
        raise ValueError(f"trace {name!r}: malformed DAX XML ({e})") from e
    if _strip_ns(root.tag) != "adag":
        raise ValueError(
            f"trace {name!r}: root element is <{_strip_ns(root.tag)}>, "
            f"expected <adag>")
    dax_name = root.get("name") or name

    ids: List[str] = []
    index: Dict[str, int] = {}
    specs: List[dict] = []
    produced: Dict[str, int] = {}          # file name -> producer position
    inputs_of: List[List[Tuple[str, float]]] = []
    namespace = None
    for el in root:
        if _strip_ns(el.tag) != "job":
            continue
        jid = el.get("id")
        if jid is None:
            raise ValueError(f"trace {name!r}: <job> without id")
        if jid in index:
            raise ValueError(f"trace {name!r}: duplicate job id {jid!r}")
        namespace = namespace or el.get("namespace")
        out_mb = 0.0
        ins: List[Tuple[str, float]] = []
        for u in el:
            if _strip_ns(u.tag) != "uses":
                continue
            fname = u.get("file") or u.get("name") or ""
            mb = _finite_nonneg(u.get("size") or 0, f"size of {fname!r}",
                                name, jid) / 1e6
            if (u.get("link") or "").lower() == "output":
                out_mb += mb
                produced[fname] = len(specs)
            else:
                ins.append((fname, mb))
        index[jid] = len(specs)
        ids.append(jid)
        specs.append({"runtime_s": _finite_nonneg(el.get("runtime") or 0.0,
                                                  "runtime", name, jid),
                      "out_mb": out_mb, "ext_mb": 0.0})
        inputs_of.append(ins)

    # Dedup repeated declarations (same parent listed twice, or the same
    # <child> relation restated): a duplicate edge would double-count the
    # parent's output in the child's input volume downstream.
    edges: List[Tuple[int, int]] = []
    seen = set()
    for el in root:
        if _strip_ns(el.tag) != "child":
            continue
        cref = el.get("ref")
        if cref not in index:
            raise ValueError(
                f"trace {name!r}: <child ref={cref!r}> names no job")
        for p in el:
            if _strip_ns(p.tag) != "parent":
                continue
            pref = p.get("ref")
            if pref not in index:
                raise ValueError(
                    f"trace {name!r}: <parent ref={pref!r}> of child "
                    f"{cref!r} names no job")
            if pref == cref:
                raise ValueError(
                    f"trace {name!r}: job {cref!r} declares itself as "
                    f"its own parent (self-edge)")
            edge = (index[pref], index[cref])
            if edge not in seen:
                seen.add(edge)
                edges.append(edge)

    # Inputs nobody produces are staged from global storage.
    for i, ins in enumerate(inputs_of):
        specs[i]["ext_mb"] = sum(
            mb for fname, mb in ins if produced.get(fname) is None)
    return _finish(dax_name, namespace.lower() if namespace else None,
                   specs, edges)


# ---------------------------------------------------------------------------
# WfCommons JSON
# ---------------------------------------------------------------------------


def load_wfcommons(source: Source, name: str = "wfcommons") -> Workflow:
    """Parse a WfCommons workflow-instance JSON into a Workflow."""
    try:
        doc = json.loads(_read(source))
    except json.JSONDecodeError as e:
        raise ValueError(
            f"trace {name!r}: malformed WfCommons JSON ({e})") from e
    if not isinstance(doc, dict):
        raise ValueError(
            f"trace {name!r}: top-level JSON is not an object")
    wf_name = doc.get("name") or name
    if not isinstance(wf_name, str):
        raise ValueError(f"trace {name!r}: workflow name is not a string")
    body = doc.get("workflow")
    if not isinstance(body, dict):
        raise ValueError(f"trace {name!r}: missing 'workflow' object")
    rows = body.get("tasks") or body.get("jobs")
    if not isinstance(rows, list) or not rows:
        raise ValueError(f"trace {name!r}: workflow has no tasks")

    index: Dict[str, int] = {}
    specs: List[dict] = []
    produced: Dict[str, int] = {}
    inputs_of: List[List[Tuple[str, float]]] = []
    for row in rows:
        if not isinstance(row, dict):
            raise ValueError(
                f"trace {name!r}: non-object task record ({row!r})")
        tname = row.get("name") or row.get("id")
        if tname is None:
            raise ValueError(f"trace {name!r}: task without name/id")
        if not isinstance(tname, str):
            raise ValueError(
                f"trace {name!r}: task name {tname!r} is not a string")
        if tname in index:
            raise ValueError(f"trace {name!r}: duplicate task {tname!r}")
        runtime = row.get("runtime", row.get("runtimeInSeconds", 0.0))
        out_mb = 0.0
        ins: List[Tuple[str, float]] = []
        files = row.get("files", [])
        if not isinstance(files, list):
            raise ValueError(
                f"trace {name!r}: task {tname!r} 'files' is not a list")
        for f in files:
            if not isinstance(f, dict):
                raise ValueError(
                    f"trace {name!r}: task {tname!r} has a non-object "
                    f"file record ({f!r})")
            fname = f.get("name") or ""
            if not isinstance(fname, str):
                raise ValueError(
                    f"trace {name!r}: task {tname!r} has a non-string "
                    f"file name ({fname!r})")
            mb = _finite_nonneg(
                f.get("sizeInBytes", f.get("size", 0)) or 0,
                f"size of {fname!r}", name, tname) / 1e6
            if str(f.get("link") or "").lower() == "output":
                out_mb += mb
                produced[fname] = len(specs)
            else:
                ins.append((fname, mb))
        index[tname] = len(specs)
        specs.append({"runtime_s": _finite_nonneg(runtime or 0.0, "runtime",
                                                  name, tname),
                      "out_mb": out_mb, "ext_mb": 0.0})
        inputs_of.append(ins)

    # Instances may declare an edge from either or both sides
    # (``parents`` and ``children``); keep first-seen order, dedup both.
    edges: List[Tuple[int, int]] = []
    seen = set()
    for row in rows:
        tname = row.get("name") or row.get("id")
        parents = row.get("parents", []) or []
        children = row.get("children", []) or []
        if not isinstance(parents, list) or not isinstance(children, list):
            raise ValueError(
                f"trace {name!r}: task {tname!r} parents/children is "
                f"not a list")
        for pref in parents:
            if not isinstance(pref, str):
                raise ValueError(
                    f"trace {name!r}: task {tname!r} has a non-string "
                    f"parent ref ({pref!r})")
            if pref not in index:
                raise ValueError(
                    f"trace {name!r}: task {tname!r} names unknown "
                    f"parent {pref!r}")
            if pref == tname:
                raise ValueError(
                    f"trace {name!r}: task {tname!r} declares itself as "
                    f"its own parent (self-edge)")
            edge = (index[pref], index[tname])
            if edge not in seen:
                seen.add(edge)
                edges.append(edge)
        for cref in children:
            if not isinstance(cref, str):
                raise ValueError(
                    f"trace {name!r}: task {tname!r} has a non-string "
                    f"child ref ({cref!r})")
            if cref not in index:
                raise ValueError(
                    f"trace {name!r}: task {tname!r} names unknown "
                    f"child {cref!r}")
            if cref == tname:
                raise ValueError(
                    f"trace {name!r}: task {tname!r} declares itself as "
                    f"its own child (self-edge)")
            edge = (index[tname], index[cref])
            if edge not in seen:
                seen.add(edge)
                edges.append(edge)

    for i, ins in enumerate(inputs_of):
        specs[i]["ext_mb"] = sum(
            mb for fname, mb in ins if produced.get(fname) is None)
    app = doc.get("application") \
        or (doc.get("workflow") or {}).get("application") or wf_name
    fam = infer_family(str(app))
    return _finish(wf_name, fam or str(app).lower(), specs, edges)


# ---------------------------------------------------------------------------
# Bundled traces + dispatch
# ---------------------------------------------------------------------------


def load_trace(path: Source, name: Optional[str] = None) -> Workflow:
    """Load a trace file, dispatching on extension (.dax/.xml vs .json)."""
    p = os.fspath(path) if not isinstance(path, bytes) else ""
    label = name or os.path.basename(p) or "trace"
    if p.endswith(".json"):
        return load_wfcommons(path, name=label)
    if p.endswith(".dax") or p.endswith(".xml"):
        return load_dax(path, name=label)
    raise ValueError(f"trace {label!r}: unknown extension (want "
                     f".dax/.xml or .json)")


def bundled_trace_names() -> Tuple[str, ...]:
    """Stems of the traces shipped under ``tenants/data/``."""
    names = [os.path.splitext(f)[0] for f in sorted(os.listdir(DATA_DIR))
             if f.endswith((".dax", ".xml", ".json"))]
    return tuple(names)


def bundled_trace(name: str) -> Workflow:
    """Parse one bundled trace by stem (fresh Workflow per call)."""
    for ext in (".dax", ".xml", ".json"):
        path = os.path.join(DATA_DIR, name + ext)
        if os.path.exists(path):
            return load_trace(path, name=name)
    raise ValueError(
        f"no bundled trace {name!r}; available: {bundled_trace_names()}")
