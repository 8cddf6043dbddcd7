"""IaaS substrate: VMs with FIFO local-storage caches and container images.

This is the infrastructure layer shared by every scheduling policy — the
policies differ only in *selection*, *budget handling* and *deprovisioning*,
never in the physics modelled here.

Lifecycle bookkeeping contract
------------------------------
Every VM status transition goes through a :class:`VMPool` method
(``mark_busy`` / ``mark_idle`` / ``terminate``), never through an ad-hoc
``vm.status = ...`` write.  The pool maintains a **live-state registry**
on top of the append-only ``vms`` list:

* ``_live``  — vmid → VM for every non-terminated VM;
* ``_idle``  — vmid → VM for the idle subset (``idle_vms`` is O(live),
  not O(every VM ever provisioned));
* ``data_index`` — inverted DataKey → {vmid} index over *live holders
  only* (emptied entries are pruned on eviction and termination);
* ``app_image`` / ``app_active`` — per-app vmid sets mirroring the
  container-image caches (the batched scheduling cycle builds its
  container-delay vectors from these instead of per-VM Python calls);
* ``tag_members`` — owner_tag → vmid set (sharing-scope masks);
* per-vmid ``mips`` / ``bandwidth`` / ``price`` float64 arrays plus the
  ``type_idx`` int array, grown amortized on provision (device-friendly
  gathers by vmid; float64 so the vectorized scheduler reproduces the
  scalar estimates bit-for-bit, cast to f32 only at the kernel boundary).

``VM.idle_epoch`` increments on every →IDLE transition; deferred REAP
events carry the epoch they were armed for, so a reap can never kill a
VM that was reused after the reap was scheduled (the old
``idle_since_ms`` timestamp marker collides when a VM goes busy and
returns to idle within the same millisecond).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.types import MS, PlatformConfig, VMType

# Data items are keyed by their producer: ("out", wid, tid) for task outputs,
# ("ext", wid, tid) for staged external inputs.
DataKey = Tuple[str, int, int]

VM_PROVISIONING = 1
VM_IDLE = 2
VM_BUSY = 3
VM_TERMINATED = 4


@dataclasses.dataclass(slots=True)
class VM:
    vmid: int
    vmt_idx: int
    vmt: VMType
    status: int = VM_PROVISIONING
    lease_start_ms: int = 0
    ready_ms: int = 0                 # provisioning completes
    idle_since_ms: int = 0
    idle_epoch: int = 0               # bumps on every →IDLE transition
    busy_ms: int = 0                  # accumulated busy time (utilization)
    terminated_ms: int = -1
    active_container: Optional[str] = None
    owner_tag: Optional[object] = None  # NS: wid; WS: app; else None
    # Spot market (repro_torch.chaos): spot leases bill at price_per_bp — the
    # discounted rate — and may be revoked; on-demand leases keep
    # price_per_bp == vmt.cost_per_bp (set by __post_init__, so direct
    # VM(...) construction bills identically to the benign model).
    spot: bool = False
    price_per_bp: float = -1.0
    # FIFO caches: plain dicts (insertion-ordered since 3.7) — membership
    # checks on these are the hottest ops in the scheduler, and dict
    # lookups beat OrderedDict's doubly-linked bookkeeping.  FIFO
    # eviction pops the first key via iteration order.
    image_cache: Dict[str, bool] = dataclasses.field(default_factory=dict)
    data_cache: Dict[DataKey, float] = dataclasses.field(
        default_factory=dict
    )
    cached_mb: float = 0.0

    def __post_init__(self) -> None:
        if self.price_per_bp < 0.0:
            self.price_per_bp = self.vmt.cost_per_bp

    # ----- container image cache ------------------------------------------
    def container_ms(self, cfg: PlatformConfig, app: str, use_containers: bool) -> int:
        """Time to make ``app``'s container active on this VM."""
        if not use_containers:
            return 0
        if self.active_container == app:
            return 0
        if app in self.image_cache:
            return cfg.container_init_ms
        return cfg.container_provision_ms

    def activate_container(
        self,
        cfg: PlatformConfig,
        app: str,
        use_containers: bool,
        evicted: Optional[List[str]] = None,
    ) -> int:
        ms = self.container_ms(cfg, app, use_containers)
        if not use_containers:
            return 0
        if app not in self.image_cache:
            self.image_cache[app] = True
        self.active_container = app
        while len(self.image_cache) > cfg.image_slots:
            old = next(iter(self.image_cache))  # FIFO eviction
            del self.image_cache[old]
            if self.active_container == old:
                # An evicted image can't stay active — otherwise later
                # container_ms calls report 0 for an uncached image.
                self.active_container = None
            if evicted is not None:
                evicted.append(old)
        return ms

    # ----- data cache -------------------------------------------------------
    def has_data(self, key: DataKey) -> bool:
        return key in self.data_cache

    def missing_mb(self, inputs: List[Tuple[DataKey, float]]) -> float:
        return sum(mb for key, mb in inputs if key not in self.data_cache)

    def has_all_inputs(self, inputs: List[Tuple[DataKey, float]]) -> bool:
        return all(key in self.data_cache for key, mb in inputs if mb > 0)

    def cache_put(self, cfg: PlatformConfig, key: DataKey, mb: float,
                  index: Optional[Dict[DataKey, set]] = None) -> None:
        if mb <= 0:
            return
        if key in self.data_cache:
            return  # already cached; FIFO order unchanged (paper: FIFO, not LRU)
        self.data_cache[key] = mb
        self.cached_mb += mb
        if index is not None:
            index.setdefault(key, set()).add(self.vmid)
        cap_mb = self.vmt.storage_mb
        while (
            self.cached_mb > cap_mb or len(self.data_cache) > cfg.cache_slots
        ) and self.data_cache:
            old_key = next(iter(self.data_cache))   # FIFO eviction
            old_mb = self.data_cache.pop(old_key)
            self.cached_mb -= old_mb
            if index is not None and old_key in index:
                holders = index[old_key]
                holders.discard(self.vmid)
                if not holders:
                    del index[old_key]  # keep the index free of dead entries


class VMPool:
    """The platform's leased-VM inventory plus lifetime accounting.

    ``vms`` is the append-only historical record (vmids are list indices
    and never reused); the live-state registry documented in the module
    docstring keeps every per-cycle query O(live).
    """

    def __init__(self, cfg: PlatformConfig):
        self.cfg = cfg
        self.vms: List[VM] = []
        self.data_index: Dict[DataKey, set] = {}
        # Live-state registry (vmid-keyed; see module docstring).
        self._live: Dict[int, VM] = {}
        self._idle: Dict[int, VM] = {}
        self.app_image: Dict[str, set] = {}
        self.app_active: Dict[str, set] = {}
        self.tag_members: Dict[object, set] = {}
        # Per-vmid static VM-type attributes, grown amortized on provision.
        # float64: the vectorized scheduler.select computes the same IEEE
        # doubles as the scalar reference from these (the affinity kernel
        # casts to f32 at its buffer boundary, same rounding as before).
        self.mips = np.empty(64, np.float64)
        self.bandwidth = np.empty(64, np.float64)
        self.price = np.empty(64, np.float64)
        self.type_idx = np.zeros(64, np.int64)
        self.vm_seconds_by_type: Dict[str, float] = {
            v.name: 0.0 for v in cfg.vm_types
        }
        self.vm_busy_seconds_by_type: Dict[str, float] = {
            v.name: 0.0 for v in cfg.vm_types
        }
        self.vm_count_by_type: Dict[str, int] = {v.name: 0 for v in cfg.vm_types}

    # ----- lifecycle transitions -------------------------------------------
    def provision(self, vmt_idx: int, now_ms: int, owner_tag=None,
                  spot: bool = False,
                  price_per_bp: Optional[float] = None) -> VM:
        """``spot``/``price_per_bp``: spot-market lease terms
        (repro_torch.chaos).  The pool's ``price`` array deliberately keeps
        the on-demand list price either way — the scheduler *plans* at
        list price and the pipeline *bills* at ``vm.price_per_bp``, so
        selection math (and engine parity with the benign model) is
        untouched by the discount."""
        vmt = self.cfg.vm_types[vmt_idx]
        vm = VM(
            vmid=len(self.vms),
            vmt_idx=vmt_idx,
            vmt=vmt,
            status=VM_PROVISIONING,
            lease_start_ms=now_ms,
            ready_ms=now_ms + self.cfg.vm_provision_delay_ms,
            owner_tag=owner_tag,
            spot=spot,
            price_per_bp=(vmt.cost_per_bp if price_per_bp is None
                          else price_per_bp),
        )
        self.vms.append(vm)
        self._live[vm.vmid] = vm
        self.tag_members.setdefault(owner_tag, set()).add(vm.vmid)
        if vm.vmid >= len(self.mips):
            grow = max(len(self.mips) * 2, vm.vmid + 1)
            for name in ("mips", "bandwidth", "price", "type_idx"):
                old = getattr(self, name)
                arr = np.empty(grow, old.dtype)
                arr[: len(old)] = old
                setattr(self, name, arr)
        self.mips[vm.vmid] = vmt.mips
        self.bandwidth[vm.vmid] = vmt.bandwidth_mbps
        self.price[vm.vmid] = vmt.cost_per_bp
        self.type_idx[vm.vmid] = vmt_idx
        self.vm_count_by_type[vmt.name] += 1
        return vm

    def mark_busy(self, vm: VM) -> None:
        """IDLE/PROVISIONING → BUSY (a pipeline starts on the VM)."""
        vm.status = VM_BUSY
        self._idle.pop(vm.vmid, None)

    def mark_idle(self, vm: VM, now_ms: int) -> None:
        """→ IDLE: registers the VM for reuse and opens a new idle epoch."""
        vm.status = VM_IDLE
        vm.idle_since_ms = now_ms
        vm.idle_epoch += 1
        self._idle[vm.vmid] = vm

    def activate_container(self, vm: VM, app: str, use_containers: bool) -> int:
        """``VM.activate_container`` + incremental app_image/app_active sync."""
        if not use_containers:
            return 0
        prev_active = vm.active_container
        evicted: List[str] = []
        ms = vm.activate_container(self.cfg, app, use_containers, evicted)
        if prev_active is not None and prev_active != vm.active_container:
            s = self.app_active.get(prev_active)
            if s is not None:
                s.discard(vm.vmid)
                if not s:
                    del self.app_active[prev_active]
        if vm.active_container is not None:
            self.app_active.setdefault(vm.active_container, set()).add(vm.vmid)
        for old in evicted:
            s = self.app_image.get(old)
            if s is not None:
                s.discard(vm.vmid)
                if not s:
                    del self.app_image[old]
        if app in vm.image_cache:
            self.app_image.setdefault(app, set()).add(vm.vmid)
        return ms

    def terminate(self, vm: VM, now_ms: int) -> None:
        assert vm.status in (VM_IDLE, VM_PROVISIONING), "cannot kill busy VM"
        self._close(vm, now_ms)

    def revoke(self, vm: VM, now_ms: int) -> None:
        """Spot revocation (repro_torch.chaos): the *infrastructure* ends the
        lease, so — unlike :meth:`terminate`, where the scheduler must
        never kill a busy VM — any non-terminated status is legal here,
        including BUSY with a pipeline in flight (the engine requeues
        the killed task).  Cache eviction and index pruning are the
        same close-of-lease bookkeeping."""
        assert vm.status != VM_TERMINATED, "revoking a closed lease"
        self._close(vm, now_ms)

    def _close(self, vm: VM, now_ms: int) -> None:
        vm.status = VM_TERMINATED
        vm.terminated_ms = now_ms
        self._live.pop(vm.vmid, None)
        self._idle.pop(vm.vmid, None)
        tag = self.tag_members.get(vm.owner_tag)
        if tag is not None:
            tag.discard(vm.vmid)
            if not tag:
                del self.tag_members[vm.owner_tag]
        for key in vm.data_cache:
            holders = self.data_index.get(key)
            if holders is not None:
                holders.discard(vm.vmid)
                if not holders:
                    # Prune: the index must only ever name live holders.
                    del self.data_index[key]
        for app in vm.image_cache:
            s = self.app_image.get(app)
            if s is not None:
                s.discard(vm.vmid)
                if not s:
                    del self.app_image[app]
        if vm.active_container is not None:
            s = self.app_active.get(vm.active_container)
            if s is not None:
                s.discard(vm.vmid)
                if not s:
                    del self.app_active[vm.active_container]
        lease_ms = now_ms - vm.lease_start_ms
        self.vm_seconds_by_type[vm.vmt.name] += lease_ms / MS
        self.vm_busy_seconds_by_type[vm.vmt.name] += vm.busy_ms / MS

    def finalize(self, now_ms: int) -> None:
        """Close the books on any VM still alive at simulation end."""
        for vm in list(self._live.values()):
            if vm.status == VM_BUSY:
                vm.status = VM_IDLE  # should not happen on a drained sim
            self.terminate(vm, now_ms)

    # ----- live-state queries ----------------------------------------------
    def idle_vms(self) -> List[VM]:
        """Idle VMs in ascending-vmid order (the order every consumer —
        tie-breaks, auction columns — depends on), O(live)."""
        return [self._idle[k] for k in sorted(self._idle)]

    def live_vms(self) -> List[VM]:
        return [self._live[k] for k in sorted(self._live)]

    @property
    def n_live(self) -> int:
        return len(self._live)

    @property
    def n_idle(self) -> int:
        return len(self._idle)

    def check_invariants(self) -> None:
        """Registry ≡ full-history scan; indexes name live holders only.
        O(all VMs ever) — test/debug use, never on the hot path."""
        assert set(self._idle) == {
            vm.vmid for vm in self.vms if vm.status == VM_IDLE
        }, "idle registry diverged from VM statuses"
        assert set(self._live) == {
            vm.vmid for vm in self.vms if vm.status != VM_TERMINATED
        }, "live registry diverged from VM statuses"
        for key, holders in self.data_index.items():
            assert holders, f"empty holder set left in data_index for {key}"
            for vid in holders:
                vm = self.vms[vid]
                assert vm.status != VM_TERMINATED and vm.has_data(key)
        for app, holders in self.app_image.items():
            assert holders, f"empty holder set in app_image for {app}"
            for vid in holders:
                assert app in self.vms[vid].image_cache
        for app, holders in self.app_active.items():
            assert holders, f"empty holder set in app_active for {app}"
            for vid in holders:
                assert self.vms[vid].active_container == app
