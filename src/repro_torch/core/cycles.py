"""Batched scheduling cycles: Algorithm 2 as one device computation.

The sequential reference processes the ready queue task-by-task, scoring
every idle VM per task (O(T·V) Python).  This module scores ALL pairs at
once with the affinity scoring (the CUDA kernel on a CUDA device, its
plain torch version on the CPU) and resolves VM conflicts with an
auction: every unplaced task picks its best VM; the earliest task in
queue order wins each VM; losers retry against the shrunken pool.
Because pair scores are static within a cycle (caches only change when
pipelines start), the fixed point equals the sequential outcome exactly
— property-tested against the reference in tests/test_torch_cycles.py.

Tier encoding per (task, VM): 0 = out of scope (busy/wrong owner),
1 = all inputs cached, 2 = container active, 3 = idle.  Provisioning
(tier 4/5) can't conflict and stays in the per-task fallback.

Pair arrays are built from the :class:`~repro_torch.sim.cloud.VMPool`
live-state registry, not from per-VM Python calls: VM-type attributes
are vmid-indexed gathers, container-delay vectors come from the pool's
incremental ``app_image`` / ``app_active`` sets, and sharing-scope masks
from ``tag_members`` — each computed once per distinct app/tag per
cycle.  Auction rounds write into resident packed ``[B, T, V]`` buffers
(:class:`_RoundBuffers`) instead of re-allocating pad+stack copies, so
the batched kernel call pays no per-round host rebuild cost.  On a CUDA
device a round's nine arrays sit in one page-locked buffer at the
round's own shape: it goes over in one asynchronous copy into a resident
device buffer, and the four ``[B, T]`` outputs come back packed in one
copy and one wait for the host-side commit.

Two callers consume the auction:

* :func:`batched_cycle` — one simulation's cycle (used by ``SimEngine``
  when the queue×pool product is large);
* :func:`multi_cycle` — many independent simulations' cycles at once
  (used by ``core.batch_engine.BatchSimEngine``): each round stacks every
  active member's proposal into one ``[B, T, V]`` tensor and scores it
  with a single batched kernel call.

Tuning knobs (see the README "Tuning knobs" table): ``AUCTION_TAIL_PAIRS``
(=192) drains a member's auction tail through per-task ``select`` once
its remaining queue×pool product drops below it — identical outcomes
(the fixed point *is* the sequential interleaving), it just stops paying
per-round kernel dispatch for a handful of pairs.  The thresholds that
decide whether a cycle rides this module at all
(``AUCTION_MIN_PAIRS_ROUND``, legacy ``AUCTION_MIN_PAIRS_GRID``) live in
``core.batch_engine``.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.affinity import ops as aff_ops
from ..sim.cloud import VM, VMPool
from .scheduler import Placement, Policy, select
from .types import PlatformConfig, Task


def build_pair_arrays(cfg: PlatformConfig, policy: Policy,
                      tasks: Sequence[Tuple[Task, str, object, List]],
                      vms: Sequence[VM],
                      pool: VMPool):
    """tasks: [(task, app, owner_tag, inputs)] in queue order; ``vms`` are
    idle VMs in ascending-vmid order (the auction's column space)."""
    T, V = len(tasks), len(vms)
    size = np.empty(T, np.float32)
    out_mb = np.empty(T, np.float32)
    budget = np.empty(T, np.float32)
    missing = np.zeros((T, V), np.float32)
    cont = np.zeros((T, V), np.float32)
    tier = np.zeros((T, V), np.int32)

    ids = np.fromiter((vm.vmid for vm in vms), np.int64, V)
    vm_ids = {vmid: j for j, vmid in enumerate(ids.tolist())}
    # vmid-indexed gathers from the pool's static per-VM attribute arrays.
    mips = pool.mips[ids]
    bw = pool.bandwidth[ids]
    price = pool.price[ids]

    # Per-(vm, app) container state from the pool's incremental app
    # indexes — O(|holders|) per distinct app, no per-VM Python calls.
    cont_by_app = {}
    for app in {app for _, app, _, _ in tasks}:
        is_active = np.zeros(V, bool)
        if not policy.use_containers:
            cvec = np.zeros(V, np.float32)
        else:
            cvec = np.full(V, cfg.container_provision_ms, np.float32)
            for vid in pool.app_image.get(app, ()):
                j = vm_ids.get(vid)
                if j is not None:
                    cvec[j] = cfg.container_init_ms
            for vid in pool.app_active.get(app, ()):
                j = vm_ids.get(vid)
                if j is not None:
                    cvec[j] = 0.0
                    is_active[j] = True
        cont_by_app[app] = (cvec, is_active)

    # Sharing-scope masks, one per distinct owner tag this cycle.
    scope_by_tag = {}
    for tag in {tag for _, _, tag, _ in tasks}:
        s = np.zeros(V, bool)
        for vid in pool.tag_members.get(tag, ()):
            j = vm_ids.get(vid)
            if j is not None:
                s[j] = True
        scope_by_tag[tag] = s

    data_index = pool.data_index
    for i, (task, app, tag, inputs) in enumerate(tasks):
        size[i] = task.size_mi
        out_mb[i] = task.out_mb
        budget[i] = task.budget
        scope = scope_by_tag[tag]
        cvec, is_active = cont_by_app[app]
        cont[i] = cvec
        if policy.locality_tiers:
            have_all = scope.copy()
            miss = np.zeros(V, np.float32)
            for key, mb in inputs:
                holders = data_index.get(key, ())
                hold = np.zeros(V, bool)
                for vid in holders:
                    j = vm_ids.get(vid)
                    if j is not None:
                        hold[j] = True
                miss += np.where(hold, 0.0, mb)
                if mb > 0:
                    have_all &= hold
            missing[i] = miss
            t = np.where(have_all, 1,
                         np.where(is_active & policy.use_containers, 2, 3))
        else:
            missing[i] = sum(mb for _, mb in inputs)
            t = np.full(V, 3, np.int32)
        tier[i] = np.where(scope, t, 0)
    return (size, out_mb, budget, missing, cont, tier, mips, bw, price)


# Below this remaining queue×pool pair product a request finishes its
# auction serially instead of riding further kernel rounds — the commit
# rule's conflict tails otherwise pay per-round device dispatch for a
# handful of pairs.  Serial and kernel resolution are bit-exact.
AUCTION_TAIL_PAIRS = 192


def _p2(n: int) -> int:
    """Next power of two ≥ max(n, 2) — shape buckets so resident round
    buffers are reused across cycles instead of reallocated per shape
    (padding rows/cols are tier-0 ⇒ infeasible ⇒ inert)."""
    return 1 << max(n - 1, 1).bit_length()


class _RoundBuffers:
    """Resident packed round buffers for auction rounds, bucketed by
    power-of-two ``(Bp, Tp, Vp)`` shape.

    Mixed-size rounds (a big round followed by small ones, the normal
    shape of the aggregate dispatcher) would thrash a single bucket, so:

    * multiple buckets stay resident (dict, LRU-evicted once the summed
      ``B·T·V`` exceeds ``MAX_RESIDENT_ELEMS``);
    * a round reuses the smallest resident bucket that covers its shape
      (up to ``COVER_SLACK``× element blowup — riding a slightly-larger
      resident bucket beats allocating a new one), growing buckets
      geometrically via the power-of-two dims;
    * a round is laid out at its own shape inside the bucket
      (:class:`~repro_torch.kernels.affinity.ops.RoundView`), so on a
      CUDA device it copies its own bytes, not the bucket's.

    Each bucket is one :class:`~repro_torch.kernels.affinity.ops.
    PackedRound`: one host allocation for the nine arrays (page-locked
    for a CUDA device, plain on the CPU) and, on a CUDA device, its
    resident device twin and packed output buffers.
    :meth:`CycleRequest.propose_into` writes through the view's numpy
    arrays.

    The cache is thread-local (each thread driving engines gets its own
    buffers — rounds from concurrent runs never interleave on shared
    arrays); over-cap outliers allocate fresh per round rather than
    pinning hundreds of MB at module scope.
    """

    __slots__ = ("buckets", "lru", "device")

    # Largest summed B·T·V kept alive between rounds (~4M pair elements
    # ⇒ ≲50 MB across the six [B,T,V] arrays).
    MAX_RESIDENT_ELEMS = 1 << 22
    # Max element blowup tolerated when riding a larger resident bucket.
    COVER_SLACK = 4

    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.buckets = {}   # (Bp, Tp, Vp) -> PackedRound
        self.lru = []       # keys, most-recently-used last
        self.device = torch.device(device)

    def _touch(self, key) -> None:
        if self.lru and self.lru[-1] == key:
            return
        try:
            self.lru.remove(key)
        except ValueError:
            pass
        self.lru.append(key)

    def get(self, Bp: int, Tp: int, Vp: int):
        """The round ``[Bp, Tp, Vp]``'s view in a resident bucket, reset to
        inert padding.  The whole view is reset, at the round's own size:
        where the previous round of the bucket had the same shape, that
        clears what its views covered; where the shape changed, the bytes
        hold another layout."""
        req = Bp * Tp * Vp
        best = None
        for key in self.buckets:
            if key[0] >= Bp and key[1] >= Tp and key[2] >= Vp:
                if best is None or (key[0] * key[1] * key[2]
                                    < best[0] * best[1] * best[2]):
                    best = key
        if best is not None \
                and best[0] * best[1] * best[2] <= self.COVER_SLACK * req:
            view = self.buckets[best].view(Bp, Tp, Vp)
            view.reset()
            self._touch(best)
            return view
        view = aff_ops.PackedRound(Bp, Tp, Vp, self.device).view(Bp, Tp, Vp)
        view.reset()
        if req <= self.MAX_RESIDENT_ELEMS:
            key = (Bp, Tp, Vp)
            self.buckets[key] = view.bucket
            self._touch(key)
            total = sum(k[0] * k[1] * k[2] for k in self.buckets)
            while total > self.MAX_RESIDENT_ELEMS and len(self.lru) > 1:
                old = self.lru.pop(0)
                total -= old[0] * old[1] * old[2]
                del self.buckets[old]
        # else: one-shot buffers — leave resident buckets intact.
        return view


class _ThreadLocalBuffers(threading.local):
    def __init__(self):
        self.by_device = {}

    def for_device(self, device: torch.device) -> _RoundBuffers:
        rb = self.by_device.get(device)
        if rb is None:
            rb = self.by_device[device] = _RoundBuffers(device)
        return rb


_ROUND_BUFFERS = _ThreadLocalBuffers()

# Mesh placement seam for the round buffers (stubbed: splitting the
# rounds over a mesh is deferred tuning).  ``parallel.sharding`` is
# imported lazily: it pulls in the model registry, which has no business
# on the simulation hot path.
_ROUND_BUFFER_PLACEMENT = None


def set_round_buffer_mesh(mesh) -> None:
    """Install a device mesh for future round-buffer placement.  With
    ``mesh=None`` (the default state) nothing is recorded; with a mesh,
    the replicated placement (``parallel.sharding.round_buffer_placement``)
    is computed and recorded but — as in the reference — only consulted
    by tests: the rounds are staged and scored as without a mesh."""
    global _ROUND_BUFFER_PLACEMENT
    if mesh is None:
        _ROUND_BUFFER_PLACEMENT = None
        return
    from ..parallel.sharding import round_buffer_placement
    _ROUND_BUFFER_PLACEMENT = round_buffer_placement(mesh)


class CycleRequest:
    """One simulation's auction state inside a (possibly multi-sim) cycle.

    Owns the pair arrays, the queue-order task list, the availability
    mask, and the serial-dictatorship commit rule.  ``multi_cycle`` only
    orchestrates rounds; all per-simulation semantics live here.
    """

    def __init__(self, cfg: PlatformConfig, policy: Policy,
                 tasks, vms: Sequence[VM], pool: VMPool,
                 tables: Optional[Sequence] = None):
        self.cfg = cfg
        self.policy = policy
        self.pool = pool
        self.tables = tables   # per-task CostTables for serial resolution
        self.tasks = list(tasks)
        self.vms = list(vms)
        T, V = len(tasks), len(vms)
        self.T, self.V = T, V
        self.col = {vm.vmid: j for j, vm in enumerate(self.vms)}
        self.placements: List[Optional[Placement]] = [None] * T
        self.unplaced: List[int] = list(range(T)) if V else []
        self.avail = np.ones(V, bool)
        self.stalled = False
        if T and V:
            (self.size, self.out_mb, self.budget, self.missing, self.cont,
             self.tier, self.mips, self.bw, self.price) = build_pair_arrays(
                cfg, policy, tasks, vms, pool)

    @property
    def active(self) -> bool:
        return bool(self.unplaced) and bool(self.avail.any()) \
            and not self.stalled

    def propose_into(self, bufs, b: int) -> None:
        """Write this member's current unplaced rows into batch row ``b``
        of the shared resident buffers (already reset to inert padding)."""
        size, out_mb, budget, missing, cont, tier, mips, bw, price = bufs
        sel = self.unplaced
        Tr, V = len(sel), self.V
        size[b, :Tr] = self.size[sel]
        out_mb[b, :Tr] = self.out_mb[sel]
        budget[b, :Tr] = self.budget[sel]
        missing[b, :Tr, :V] = self.missing[sel]
        cont[b, :Tr, :V] = self.cont[sel]
        tier[b, :Tr, :V] = self.tier[sel] * self.avail[None, :]
        mips[b, :V] = self.mips
        bw[b, :V] = self.bw
        price[b, :V] = self.price

    def _select_serial(self, ti: int) -> Placement:
        """The per-task reference rule for task ``ti`` against the
        auction's *current* availability set — the same ``select`` call,
        at the same point in the serial order, the sequential reference
        makes.  Used both for kernel-infeasible rows (insufficient-budget
        tier-4/5 resolution) and for the serial tail drain."""
        task, app, tag, inputs = self.tasks[ti]
        avail = [vm for j, vm in enumerate(self.vms) if self.avail[j]]
        return select(self.cfg, self.policy, task, -1, app, inputs,
                      task.budget, avail, owner_tag=tag, pool=self.pool,
                      table=self.tables[ti] if self.tables else None)

    def finish_serial(self) -> None:
        """Drain every remaining unplaced task with the per-task
        reference rule, in queue order, against the live availability
        set.  The auction's fixed point *is* sequential per-task
        processing (the property the whole module rests on), so the tail
        is bit-exact either way — and a few Python selects beat a long
        conflict tail of near-empty kernel rounds."""
        for ti in self.unplaced:
            p = self._select_serial(ti)
            self.placements[ti] = p
            if p.vm is not None:
                self.avail[self.col[p.vm.vmid]] = False
        self.unplaced = []

    def commit(self, best, tiers, fins, costs_) -> None:
        """Serial-dictatorship prefix commit: the winner of each VM is its
        earliest claimant, and only winners EARLIER than the first loser
        commit this round.  A later round-1 winner could otherwise steal
        the VM an earlier loser takes next — exactly the interleaving
        the sequential reference produces.

        Tasks with no feasible VM (best < 0) resolve *in serial position*
        through :meth:`_select_serial` — the insufficient-budget
        tier-5 rule may take an idle VM, in which case every later task
        this round is deferred (``halted``) and re-auctions against the
        shrunken pool, exactly as the sequential reference would see it."""
        claims: dict = {}
        for row, ti in enumerate(self.unplaced):
            j = int(best[row])
            if j >= 0 and j not in claims:
                claims[j] = ti
        losers = [ti for row, ti in enumerate(self.unplaced)
                  if int(best[row]) >= 0 and claims[int(best[row])] != ti]
        first_loser = min(losers) if losers else None
        next_unplaced = []
        committed = False
        halted = False
        for row, ti in enumerate(self.unplaced):
            j = int(best[row])
            if halted or (first_loser is not None and ti > first_loser):
                next_unplaced.append(ti)
                continue
            if j < 0:
                p = self._select_serial(ti)
                self.placements[ti] = p
                committed = True
                if p.vm is not None:
                    # Tier-5 reuse consumed a VM the kernel scored as
                    # infeasible; later tasks must re-auction without it.
                    self.avail[self.col[p.vm.vmid]] = False
                    halted = True
                continue
            if claims[j] == ti:
                self.placements[ti] = Placement(
                    self.vms[j], None, int(tiers[row]),
                    int(fins[row]), float(costs_[row]))
                self.avail[j] = False
                committed = True
            else:
                next_unplaced.append(ti)
        self.unplaced = next_unplaced
        self.stalled = not committed


def _score_round(cfg: PlatformConfig, view):
    """Score one staged round (a packed ``RoundView``) where its bucket
    lives; return the four ``[B, T]`` outputs as host numpy arrays.  On a
    CUDA device the round goes over in one copy, and the packed outputs
    come back in one copy and one wait, so the host buffers are free
    again when this returns."""
    return aff_ops.affinity_round(
        view, gs_read=cfg.gs_read_mbps, gs_write=cfg.gs_write_mbps,
        bp_ms=float(cfg.billing_period_ms))


def multi_cycle(cfg: PlatformConfig, requests: Sequence[CycleRequest],
                device: Union[None, str, torch.device] = None
                ) -> List[List[Optional[Placement]]]:
    """Run every request's auction to its fixed point, scoring all active
    members' rounds with ONE batched kernel call per round.

    Members are independent simulations, so rounds interleave freely; a
    member drops out as soon as it has no unplaced task, no available VM,
    or a round commits nothing.  Rounds fill the resident power-of-two
    ``(B, T, V)`` buffers (``_RoundBuffers``) so nothing is allocated per
    round once a bucket is resident.

    Requests whose remaining task×VM pair product drops below
    ``AUCTION_TAIL_PAIRS`` leave the fixed point and drain serially
    (:meth:`CycleRequest.finish_serial`, bit-exact): conflict tails
    otherwise stretch into dozens of near-empty kernel rounds whose
    dispatch overhead dwarfs the scoring they do.

    ``device``: where rounds are scored — ``"cuda"`` (the default for
    ``None``) runs the CUDA kernel, ``"cpu"`` the plain torch version.
    """
    dev = resolve_device(device)
    rb = _ROUND_BUFFERS.for_device(dev)
    while True:
        active = []
        for r in requests:
            if not r.active:
                continue
            if len(r.unplaced) * int(r.avail.sum()) < AUCTION_TAIL_PAIRS:
                r.finish_serial()
            else:
                active.append(r)
        if not active:
            break
        Tp = max(_p2(len(r.unplaced)) for r in active)
        Vp = max(_p2(r.V) for r in active)
        # Batch dim rounds to 1, 2, 4, … (a solo auction stays unpadded);
        # rows beyond the active members keep the inert padding.
        Bp = 1 << max(len(active) - 1, 0).bit_length()
        view = rb.get(Bp, Tp, Vp)
        for b, r in enumerate(active):
            r.propose_into(view.arrays, b)
        best, tiers, fins, costs_ = _score_round(cfg, view)
        for b, r in enumerate(active):
            r.commit(best[b], tiers[b], fins[b], costs_[b])
    return [r.placements for r in requests]


def batched_cycle(cfg: PlatformConfig, policy: Policy,
                  tasks, vms: Sequence[VM], pool: VMPool,
                  device: Union[None, str, torch.device] = None, tables=None
                  ) -> List[Optional[Placement]]:
    """Returns, per task (queue order), a reuse Placement or None (task
    needs the provisioning fallback)."""
    if not tasks:
        return []
    if not vms:
        return [None] * len(tasks)
    req = CycleRequest(cfg, policy, tasks, vms, pool, tables=tables)
    return multi_cycle(cfg, [req], device=device)[0]
