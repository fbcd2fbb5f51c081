"""The Execution Controller (paper §4.3-4.4): profile-driven placement.

Decision procedure (faithful to the paper):
 - first encounter of a method: environment-only decision (offload iff the
   connection quality is good);
 - subsequently: predict (time, energy) for local vs remote from profiler
   history + current network state, apply the user policy;
 - remote path: serialize -> transfer -> [resume clones] -> execute ->
   return results + profiling data; OutOfMemoryError-equivalents escalate to
   a more powerful clone (paper §5.1/§7.3 image combiner); connection
   failures fall back to local execution and trigger async reconnection.

Every venue executes on one device, ``device`` (the card unless the caller
names another): the phone's runs and the clones' runs are timed there after
a device synchronise and scaled to the venue, and ``ExecutionResult``
times are seconds on the controller's virtual clock.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core import venues as V
from repro_torch.core.clock import VirtualClock, ensure_clock
from repro_torch.core.clones import ClonePool, CloneState
from repro_torch.core.dispatch import Dispatcher
from repro_torch.core.energy import PowerTutorModel
from repro_torch.core.faults import FaultPlan, ReconnectManager, VenueFailure
from repro_torch.core.parallel import Parallelizer
from repro_torch.core.policy import Policy, Prediction, should_offload
from repro_torch.core.profilers import (DeviceProfiler, NetworkProfiler,
                                        ProgramProfiler, size_bucket)
from repro_torch.core.remoteable import RemoteableMethod


@dataclasses.dataclass
class ExecutionResult:
    value: Any
    offloaded: bool
    venue: str
    time_s: float                   # end-to-end scenario latency (virtual)
    energy: Dict[str, float]        # client-side per-component joules
    overhead_s: float = 0.0         # transfer + provisioning
    tx_bytes: int = 0
    rx_bytes: int = 0
    escalations: int = 0
    fell_back: bool = False
    redispatches: int = 0
    n_clones: int = 1

    @property
    def energy_j(self) -> float:
        return sum(self.energy.values())


class ExecutionController:
    def __init__(self, policy: Policy = Policy.EXEC_TIME,
                 link: str = "wifi-local",
                 pool: Optional[ClonePool] = None,
                 clone_type: str = "main",
                 fault_plan: Optional[FaultPlan] = None,
                 phone: Optional[V.VenueSpec] = None,
                 clock: Optional[VirtualClock] = None,
                 device: Optional[Union[str, torch.device]] = None):
        # decision layer (this class) + execution layer (Dispatcher) share
        # one virtual timeline; a supplied pool donates its clock when it
        # already has a virtual one
        if clock is not None:
            self.clock = ensure_clock(clock)
        elif pool is not None and getattr(pool.clock, "virtual", False):
            self.clock = pool.clock
        else:
            self.clock = VirtualClock()
        self.policy = policy
        self.pool = pool or ClonePool(link_name=link, clock=self.clock)
        self.clone_type = clone_type
        self.device = DeviceProfiler()
        self.device.observe(conn_subtype=link,
                            connectivity="cell" if link == "3g" else "wifi")
        self.network = NetworkProfiler(link)
        self.program = ProgramProfiler()
        self.phone_energy = PowerTutorModel()
        # the venue on which every run executes: resolves ``device`` (the
        # card by default, raising where there is none)
        self.phone = V.Venue(phone or V.make_phone(), device)
        self.faults = fault_plan or FaultPlan()
        self.reconnect = ReconnectManager()
        self.dispatcher = Dispatcher(self.pool, self.clock, self.phone.device)
        self.parallelizer = Parallelizer(self.pool, clock=self.clock,
                                         device=self.phone.device)
        self.decisions = {"local": 0, "remote": 0, "fallback": 0,
                          "escalations": 0}

    # ------------------------------------------------------------------ api
    def set_link(self, link: str) -> None:
        self.network.switch(link)
        self.pool.link = V.LINKS[link]
        self.device.observe(conn_subtype=link,
                            connectivity="cell" if link == "3g" else "wifi",)

    def execute(self, rm: RemoteableMethod, *args, n_clones: int = 1,
                clone_type: Optional[str] = None,
                force: Optional[str] = None, **kw) -> ExecutionResult:
        """Run a remoteable method under the current policy.

        ``force`` in {"local", "remote"} bypasses the decision (benchmarks).
        """
        clone_type = clone_type or self.clone_type
        skey = size_bucket(rm.size_key(*args, **kw))
        tx = V.pytree_bytes((args, kw))

        offload = self._decide(rm, skey, tx, force, n_clones)
        if not offload:
            return self._run_local(rm, skey, *args, **kw)
        try:
            return self._run_remote(rm, skey, tx, clone_type, n_clones,
                                    *args, **kw)
        except VenueFailure:
            # paper §4.4: fall back to local, discard the run's profiling
            # data, reconnect asynchronously
            self.decisions["fallback"] += 1
            self.reconnect.notify_failure()
            res = self._run_local(rm, skey, *args, record=False, **kw)
            return dataclasses.replace(res, fell_back=True)

    # ------------------------------------------------------------- decision
    def _decide(self, rm: RemoteableMethod, skey: int, tx: int,
                force: Optional[str], n_clones: int) -> bool:
        if force == "local":
            return False
        if force == "remote":
            return True
        if self.policy is Policy.NONE:
            return False
        if self.device.connection_quality() == "none":
            return False
        if not self.program.known(rm.name):
            # first encounter: environment-only (paper §4.3)
            return self.device.connection_quality() == "good"
        local = self._predict_local(rm, skey)
        remote = self._predict_remote(rm, skey, tx, n_clones)
        if local is None:
            return True
        if remote is None:
            return False
        return should_offload(self.policy, local, remote)

    def _predict_local(self, rm, skey) -> Optional[Prediction]:
        r = (self.program.lookup(rm.name, skey, "phone")
             or self.program.nearest(rm.name, skey, "phone"))
        if r is None or r.exec_time is None:
            rr = self.program.nearest(rm.name, skey, "cloud")
            if rr is None or rr.exec_time is None:
                return None
            # scale cloud history by the venue speed ratio
            ratio = (self.pool.primary.spec.eff_flops
                     / self.phone.spec.eff_flops)
            t = rr.exec_time * ratio
        else:
            t = r.exec_time
        e = sum(self.phone_energy.local_exec_energy(t).values())
        return Prediction(t, e)

    def _predict_remote(self, rm, skey, tx: int,
                        n_clones: int) -> Optional[Prediction]:
        r = (self.program.lookup(rm.name, skey, "cloud")
             or self.program.nearest(rm.name, skey, "cloud"))
        if r is None or r.exec_time is None:
            rr = self.program.nearest(rm.name, skey, "phone")
            if rr is None or rr.exec_time is None:
                return None
            ratio = (self.phone.spec.eff_flops
                     / self.pool.primary.spec.eff_flops)
            t_exec = rr.exec_time * ratio
        else:
            t_exec = r.exec_time
        t_exec = t_exec / max(1, n_clones)              # parallelizable part
        rx = (r.rx_bytes if r and r.rx_bytes else 1024)
        t_net = self.network.transfer_time(tx) + self.network.transfer_time(
            int(rx))
        t_resume = self._provision_estimate(n_clones)
        t_total = t_net + t_resume + t_exec
        link = self.network.active
        tx_seconds = t_net
        e = sum(self.phone_energy.offload_energy(
            t_total - tx_seconds, tx_seconds, link).values())
        return Prediction(t_total, e)

    def _provision_estimate(self, n: int) -> float:
        from repro_torch.core.clones import BOOT_SECONDS, resume_time
        avail = [c for c in self.pool.clones
                 if not c.busy and c.ctype.name == self.clone_type]
        running = sum(c.state is CloneState.RUNNING for c in avail)
        paused = sum(c.state is CloneState.PAUSED for c in avail)
        need = max(0, n - running)
        if need == 0:
            return 0.0
        if need <= paused:
            return resume_time(need)
        return BOOT_SECONDS

    # ------------------------------------------------------------ execution
    def _run_local(self, rm, skey, *args, record: bool = True,
                   **kw) -> ExecutionResult:
        self.decisions["local"] += 1
        value, t = self.phone.execute(rm.callable(), *args, **kw)
        self.clock.sleep(t)                 # charge to the shared timeline
        energy = self.phone_energy.local_exec_energy(t)
        if record:
            self.program.record(rm.name, skey, "phone", exec_time=t,
                                energy=sum(energy.values()))
        return ExecutionResult(value, False, "phone", t, energy)

    def _run_remote(self, rm, skey, tx: int, clone_type: str, n_clones: int,
                    *args, **kw) -> ExecutionResult:
        self.decisions["remote"] += 1
        if self.faults.check():
            raise VenueFailure("connection lost during remote execution")

        if n_clones > 1 and rm.parallelizable:
            return self._run_parallel(rm, skey, tx, clone_type, n_clones,
                                      *args, **kw)

        t0 = self.clock.now()
        escalations = 0
        ctype = clone_type
        mem_need = rm.mem_fn(*args, **kw) if rm.mem_fn else 0
        clones, provision_s = self.pool.acquire(ctype, n=1)
        clone = clones[0]
        # OutOfMemoryError handling (paper §5.1): escalate to a more
        # powerful clone instead of surfacing the error to the client.
        while not V.Venue(clone.spec, self.phone.device).fits(mem_need):
            nxt = self.pool.escalate_type(ctype)
            if nxt is None:
                break
            self.pool.release([clone])
            ctype = nxt
            clones, extra = self.pool.acquire(ctype, n=1)
            clone = clones[0]
            provision_s += extra
            escalations += 1
        self.decisions["escalations"] += escalations

        # upload, then provision + execute as one dispatched task whose
        # completion is an event on the timeline
        t_tx = self.network.transfer_time(tx)
        self.clock.sleep(t_tx)
        fn = rm.callable()
        call = (lambda *a: fn(*a, **kw)) if kw else fn
        task = self.dispatcher.submit(clone, call, args,
                                      extra_delay=provision_s, label=rm.name)
        self.dispatcher.wait([task])
        value, t_exec = task.value, task.venue_seconds
        rx = V.pytree_bytes(value)
        t_rx = self.network.transfer_time(rx)
        self.clock.sleep(t_rx)
        self.network.observe_transfer(tx + rx, t_tx + t_rx)
        self.network.observe_rtt(self.network.rtt())
        overhead = t_tx + t_rx + provision_s
        t_total = self.clock.now() - t0     # == overhead + t_exec
        energy = self.phone_energy.offload_energy(
            t_total - (t_tx + t_rx), t_tx + t_rx, self.network.active)
        self.program.record(rm.name, skey, "cloud", exec_time=t_exec,
                            energy=sum(energy.values()), tx=tx, rx=rx)
        self.pool.release(clones)
        self.pool.reap_idle()
        return ExecutionResult(value, True, clone.spec.name, t_total, energy,
                               overhead_s=overhead, tx_bytes=tx, rx_bytes=rx,
                               escalations=escalations)

    def _run_parallel(self, rm, skey, tx: int, clone_type: str, k: int,
                      *args, **kw) -> ExecutionResult:
        t0 = self.clock.now()
        shards = rm.split_fn(args, k)
        t_tx = self.network.transfer_time(tx)
        self.clock.sleep(t_tx)
        pres = self.parallelizer.run(rm.callable(), shards,
                                     clone_type=clone_type, merge=rm.merge_fn)
        rx = V.pytree_bytes(pres.value)
        t_rx = self.network.transfer_time(rx)
        self.clock.sleep(t_rx)
        # feed the network profiler exactly like the single-clone path, so
        # multi-clone runs keep bandwidth/RTT history fresh
        self.network.observe_transfer(tx + rx, t_tx + t_rx)
        self.network.observe_rtt(self.network.rtt())
        overhead = t_tx + t_rx + pres.resume_s + pres.sync_s
        t_total = self.clock.now() - t0     # == t_tx + makespan + t_rx
        energy = self.phone_energy.offload_energy(
            t_total - (t_tx + t_rx), t_tx + t_rx, self.network.active)
        self.program.record(rm.name, skey, "cloud",
                            exec_time=max(pres.shard_times),
                            energy=sum(energy.values()), tx=tx, rx=rx)
        return ExecutionResult(pres.value, True, f"{clone_type} x{k}",
                               t_total, energy, overhead_s=overhead,
                               tx_bytes=tx, rx_bytes=rx,
                               redispatches=pres.redispatches, n_clones=k)
