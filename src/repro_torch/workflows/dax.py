"""Synthetic DAG generators for the paper's five workflow applications.

Structures and relative task characteristics follow the Pegasus workflow
profiles (Juve et al., "Characterizing and Profiling Scientific Workflows",
FGCS 2013) that the WorkflowGenerator tool implements, scaled to the paper's
Table 1 qualitative matrix:

============  ==============  =========  =========  ===========
workflow      parallel tasks  CPU hours  I/O reqs   peak memory
============  ==============  =========  =========  ===========
CyberShake    very high       very high  very high  very high
Epigenome     medium          low        medium     medium
LIGO          medium-high     medium     high       high
Montage       high            low        high       low
SIPHT         low             low        low        medium
============  ==============  =========  =========  ===========

Sizes are in MI (runs at `MIPS` from Table 2 ⇒ seconds on the reference VM);
data volumes in MB.  Exact magnitudes are calibrated so each family's
runtime/IO ratio matches its Table 1 class — the paper's own numbers come
from the (unpublished-seed) WorkflowGenerator, so EXPERIMENTS.md validates
*orderings and trends*, not absolute seconds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..core.types import Task, Workflow


def _mk(
    rng: np.random.Generator,
    sizes_mi: Tuple[float, float],
    out_mb: Tuple[float, float],
) -> Tuple[float, float]:
    """Draw (size_mi, out_mb) from truncated normals around the given
    (mean, std) pairs."""
    s = max(rng.normal(sizes_mi[0], sizes_mi[1]), sizes_mi[0] * 0.1)
    d = max(rng.normal(out_mb[0], out_mb[1]), out_mb[0] * 0.1)
    return float(s), float(d)


def _build(wid: int, app: str, spec: List[Tuple[float, float, float]],
           edges: List[Tuple[int, int]]) -> Workflow:
    tasks = [
        Task(tid=i, size_mi=s, out_mb=o, ext_in_mb=e)
        for i, (s, o, e) in enumerate(spec)
    ]
    for u, v in edges:
        tasks[u].children.append(v)
        tasks[v].parents.append(u)
    wf = Workflow(wid=wid, app=app, tasks=tasks)
    wf.validate()
    return wf


# ---------------------------------------------------------------------------
# Montage — high fan-out, I/O heavy, short CPU (mProjectPP → mDiffFit →
# mConcatFit → mBgModel → mBackground → mImgtbl → mAdd → mShrink → mJPEG).
# ---------------------------------------------------------------------------


def montage(wid: int, n: int, rng: np.random.Generator) -> Workflow:
    k = max(3, (n - 5) // 3)  # projections
    spec: List[Tuple[float, float, float]] = []
    edges: List[Tuple[int, int]] = []
    proj = []
    for _ in range(k):
        s, o = _mk(rng, (20, 5), (40, 10))
        proj.append(len(spec))
        spec.append((s, o, 30.0))          # mProjectPP: staged sky tiles
    diff = []
    for i in range(k):
        s, o = _mk(rng, (10, 3), (2, 0.5))
        d = len(spec)
        diff.append(d)
        spec.append((s, o, 0.0))           # mDiffFit over adjacent pairs
        edges.append((proj[i], d))
        edges.append((proj[(i + 1) % k], d))
    s, o = _mk(rng, (15, 4), (1, 0.2))
    concat = len(spec)
    spec.append((s, o, 0.0))               # mConcatFit
    edges += [(d, concat) for d in diff]
    s, o = _mk(rng, (15, 4), (1, 0.2))
    bg_model = len(spec)
    spec.append((s, o, 0.0))               # mBgModel
    edges.append((concat, bg_model))
    backs = []
    for i in range(k):
        s, o = _mk(rng, (10, 3), (40, 10))
        b = len(spec)
        backs.append(b)
        spec.append((s, o, 0.0))           # mBackground
        edges.append((bg_model, b))
        edges.append((proj[i], b))
    s, o = _mk(rng, (20, 5), (5, 1))
    imgtbl = len(spec)
    spec.append((s, o, 0.0))
    edges += [(b, imgtbl) for b in backs]
    s, o = _mk(rng, (60, 15), (120, 30))
    madd = len(spec)
    spec.append((s, o, 0.0))               # mAdd: big mosaic
    edges.append((imgtbl, madd))
    s, o = _mk(rng, (15, 4), (20, 5))
    shrink = len(spec)
    spec.append((s, o, 0.0))
    edges.append((madd, shrink))
    s, o = _mk(rng, (10, 2), (5, 1))
    jpeg = len(spec)
    spec.append((s, o, 0.0))
    edges.append((shrink, jpeg))
    return _build(wid, "montage", spec, edges)


# ---------------------------------------------------------------------------
# CyberShake — very high parallelism, very high CPU AND data (ExtractSGT →
# SeismogramSynthesis → PeakValCalc, + ZipSeis/ZipPSA collectors).
# ---------------------------------------------------------------------------


def cybershake(wid: int, n: int, rng: np.random.Generator) -> Workflow:
    pairs = max(2, (n - 2) // 4)
    spec: List[Tuple[float, float, float]] = []
    edges: List[Tuple[int, int]] = []
    synths = []
    peaks = []
    for _ in range(pairs):
        s, o = _mk(rng, (110, 25), (150, 40))
        sgt = len(spec)
        spec.append((s, o, 120.0))         # ExtractSGT: huge staged SGT
        for _ in range(2):
            s2, o2 = _mk(rng, (450, 100), (180, 50))
            syn = len(spec)
            synths.append(syn)
            spec.append((s2, o2, 0.0))     # SeismogramSynthesis: heavy CPU+data
            edges.append((sgt, syn))
            s3, o3 = _mk(rng, (30, 8), (1, 0.3))
            pk = len(spec)
            peaks.append(pk)
            spec.append((s3, o3, 0.0))     # PeakValCalc
            edges.append((syn, pk))
    s, o = _mk(rng, (40, 10), (60, 15))
    zipseis = len(spec)
    spec.append((s, o, 0.0))
    edges += [(x, zipseis) for x in synths]
    s, o = _mk(rng, (30, 8), (10, 3))
    zippsa = len(spec)
    spec.append((s, o, 0.0))
    edges += [(x, zippsa) for x in peaks]
    return _build(wid, "cybershake", spec, edges)


# ---------------------------------------------------------------------------
# Epigenome — CPU-bound parallel chains (split → filter → sol2sanger →
# fastq2bfq → map → merge → index → pileup).
# ---------------------------------------------------------------------------


def epigenome(wid: int, n: int, rng: np.random.Generator) -> Workflow:
    lanes = max(2, (n - 4) // 4)
    spec: List[Tuple[float, float, float]] = []
    edges: List[Tuple[int, int]] = []
    s, o = _mk(rng, (60, 10), (15, 3))
    split = len(spec)
    spec.append((s, o, 25.0))
    maps = []
    for _ in range(lanes):
        prev = split
        for stage, (mi, mb) in enumerate(
            [((90, 20), (10, 2)), ((45, 10), (10, 2)),
             ((45, 10), (8, 2)), ((900, 180), (8, 2))]  # map = CPU hog
        ):
            s2, o2 = _mk(rng, mi, mb)
            t = len(spec)
            spec.append((s2, o2, 0.0))
            edges.append((prev, t))
            prev = t
        maps.append(prev)
    s, o = _mk(rng, (120, 25), (20, 4))
    merge = len(spec)
    spec.append((s, o, 0.0))
    edges += [(m, merge) for m in maps]
    s, o = _mk(rng, (60, 12), (10, 2))
    index = len(spec)
    spec.append((s, o, 0.0))
    edges.append((merge, index))
    s, o = _mk(rng, (90, 18), (15, 3))
    pileup = len(spec)
    spec.append((s, o, 0.0))
    edges.append((index, pileup))
    return _build(wid, "epigenome", spec, edges)


# ---------------------------------------------------------------------------
# LIGO Inspiral — medium-high parallelism, medium CPU, high I/O
# (TmpltBank → Inspiral → Thinca → TrigBank → Inspiral2 → Thinca2).
# ---------------------------------------------------------------------------


def ligo(wid: int, n: int, rng: np.random.Generator) -> Workflow:
    groups = max(2, (n - 2) // 10)
    per = 4
    spec: List[Tuple[float, float, float]] = []
    edges: List[Tuple[int, int]] = []
    thincas = []
    for _ in range(groups):
        insp = []
        for _ in range(per):
            s, o = _mk(rng, (70, 15), (25, 6))
            tb = len(spec)
            spec.append((s, o, 30.0))      # TmpltBank
            s2, o2 = _mk(rng, (320, 70), (30, 8))
            ins = len(spec)
            spec.append((s2, o2, 0.0))     # Inspiral: CPU heavy
            edges.append((tb, ins))
            insp.append(ins)
        s3, o3 = _mk(rng, (25, 6), (8, 2))
        th = len(spec)
        spec.append((s3, o3, 0.0))         # Thinca
        edges += [(i, th) for i in insp]
        thincas.append(th)
        insp2 = []
        for _ in range(per):
            s4, o4 = _mk(rng, (20, 5), (6, 2))
            tb2 = len(spec)
            spec.append((s4, o4, 0.0))     # TrigBank
            edges.append((th, tb2))
            s5, o5 = _mk(rng, (280, 60), (25, 6))
            ins2 = len(spec)
            spec.append((s5, o5, 0.0))     # Inspiral round 2
            edges.append((tb2, ins2))
            insp2.append(ins2)
        s6, o6 = _mk(rng, (25, 6), (8, 2))
        th2 = len(spec)
        spec.append((s6, o6, 0.0))
        edges += [(i, th2) for i in insp2]
    return _build(wid, "ligo", spec, edges)


# ---------------------------------------------------------------------------
# SIPHT — low parallelism, low I/O, medium memory (many small analysis tools
# feeding one FindsRNA, then annotation).
# ---------------------------------------------------------------------------


def sipht(wid: int, n: int, rng: np.random.Generator) -> Workflow:
    patsers = max(2, (n - 8) // 2)
    spec: List[Tuple[float, float, float]] = []
    edges: List[Tuple[int, int]] = []
    pats = []
    for _ in range(patsers):
        s, o = _mk(rng, (25, 6), (1.5, 0.4))
        p = len(spec)
        pats.append(p)
        spec.append((s, o, 2.0))           # Patser
    s, o = _mk(rng, (15, 4), (2, 0.5))
    pconc = len(spec)
    spec.append((s, o, 0.0))               # Patser_concat
    edges += [(p, pconc) for p in pats]
    tools = []
    for mi in [(120, 25), (90, 20), (160, 30), (90, 20), (60, 15)]:
        s2, o2 = _mk(rng, mi, (4, 1))
        t = len(spec)
        tools.append(t)
        spec.append((s2, o2, 3.0))         # Blast / FindTerm / RNAMotif / ...
    s3, o3 = _mk(rng, (220, 45), (6, 1.5))
    srna = len(spec)
    spec.append((s3, o3, 0.0))             # FindsRNA
    edges += [(t, srna) for t in tools + [pconc]]
    s4, o4 = _mk(rng, (110, 22), (4, 1))
    annot = len(spec)
    spec.append((s4, o4, 0.0))             # sRNA annotate
    edges.append((srna, annot))
    return _build(wid, "sipht", spec, edges)


# ---------------------------------------------------------------------------
# Trace-import calibration (consumed by tenants.traces).
#
# Real traces record *runtimes in seconds* on some reference host and
# *file sizes in bytes*; the simulator wants MI and MB on the Table-2
# catalogue.  Per-family calibration maps trace seconds → MI at a
# reference-machine MIPS chosen so imported workflows land in the same
# magnitude band as the synthetic Table-1 generators above (e.g. Montage
# runtimes are short/I-O bound, Epigenome map stages are CPU hogs), and
# scales byte volumes to the family's I/O class.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceCalibration:
    """Reference-host calibration for one workflow family."""

    mips: float = 4.0        # MI per traced runtime second (≈ "medium")
    mb_scale: float = 1.0    # multiplier on trace MB volumes


TRACE_CALIBRATION: Dict[str, TraceCalibration] = {
    # Montage: I/O heavy, short CPU — traced on a slow reference host.
    "montage": TraceCalibration(mips=2.0, mb_scale=1.0),
    # CyberShake: very high CPU and data.
    "cybershake": TraceCalibration(mips=8.0, mb_scale=1.0),
    # Epigenome: CPU-bound chains (map ≈ hundreds of seconds).
    "epigenome": TraceCalibration(mips=4.0, mb_scale=1.0),
    # LIGO Inspiral: medium CPU, high I/O.
    "ligo": TraceCalibration(mips=4.0, mb_scale=1.0),
    # SIPHT: low everything.
    "sipht": TraceCalibration(mips=4.0, mb_scale=1.0),
    # Seismology (cross-correlation / deconvolution): CPU-leaning tasks
    # over modest waveform volumes, traced on a mid-range host.
    "seismology": TraceCalibration(mips=6.0, mb_scale=1.0),
}

DEFAULT_TRACE_CALIBRATION = TraceCalibration()

# Substring hints mapping trace names / DAX namespaces / WfCommons
# application ids onto the five Table-1 families.
TRACE_FAMILY_HINTS: Dict[str, str] = {
    "montage": "montage",
    "cybershake": "cybershake",
    "epigenom": "epigenome",       # epigenome / epigenomics / genome-seq
    "genome": "epigenome",
    "ligo": "ligo",
    "inspiral": "ligo",
    "sipht": "sipht",
    "srna": "sipht",
    "seismolog": "seismology",     # seismology / seismological
    "iterdecon": "seismology",
}


def trace_calibration(family: str) -> TraceCalibration:
    """Calibration for a (possibly unknown) family name."""
    return TRACE_CALIBRATION.get(family, DEFAULT_TRACE_CALIBRATION)


APP_GENERATORS: Dict[str, Callable[[int, int, np.random.Generator], Workflow]] = {
    "cybershake": cybershake,
    "epigenome": epigenome,
    "ligo": ligo,
    "montage": montage,
    "sipht": sipht,
}

APP_NAMES = tuple(sorted(APP_GENERATORS))


def generate_workflow(
    app: str, wid: int, n_tasks: int, rng: np.random.Generator
) -> Workflow:
    """Generate one workflow of ``app`` with ≈ ``n_tasks`` tasks."""
    wf = APP_GENERATORS[app](wid, n_tasks, rng)
    return wf
