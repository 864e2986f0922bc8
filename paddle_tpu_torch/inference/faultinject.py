"""Fault-injection harness for the serving engine: a copy of
``paddle_tpu/inference/faultinject.py`` (standard library only).

Overload resilience is a claim about behavior under conditions a
healthy box never produces on its own — an exhausted block pool, a
scheduler that keeps losing its allocation race, a step that takes
seconds instead of milliseconds.  This module is the ONE hook point
the ``ServingEngine`` consults (``ServingEngine(fault_injector=...)``)
so tests can drive those conditions deterministically and then assert
the invariants that define "no wedge":

- ``BlockPool.check()`` stays clean after every injected failure (no
  refcount drift, no double-free, no leaked block);
- ``run(wall_timeout_s=...)`` raises a diagnosable
  ``EngineStalledError`` instead of spinning forever when progress is
  impossible;
- clearing the fault lets the SAME engine drain to completion with
  token-exact outputs — injected failures are delays, never
  corruption.

Five injectable failure modes:

- **allocation exhaustion** (``fail_allocs``): the engine's next N (or
  every) ``BlockPool.alloc`` call returns ``None`` as if the pool were
  dry — exercises admission back-off, the head-of-line valve and the
  preemption path without needing a trace that actually fills HBM.
- **forced swap-out** (``force_swap``): the named in-flight request is
  preempted to the host-RAM tier at the top of the next ``step()``
  regardless of pool pressure — the deterministic driver of the
  preempt/resume byte-parity tests.
- **step stall** (``stall_steps``): the next N ``step()`` calls sleep
  ``seconds`` before doing any work — a stand-in for a wedged device
  dispatch, paired with ``run(wall_timeout_s=...)`` regression tests.
  The injected sleep is charged to its own histogram
  (``serving.fault.stall_seconds``) and carved OUT of
  ``serving.step.host_seconds``, so fault-injection runs never
  pollute the host-scheduler baseline the dispatch-ahead pipeline is
  measured against.
- **host-tier swap-in failure** (``fail_swapins``): the next N (or
  every) prefix-cache host->HBM promotions fail at admission — the
  host parcels drop and the engine degrades the match to its directly
  mapped HBM prefix, recomputing the tail (a prefix miss, never a
  wedge, a block leak or a token drift).  Preemption RESUME swap-ins
  are deliberately out of scope: a resume needs its bytes for
  correctness, so there is no degraded path to exercise.
- **forced tier eviction** (``force_tier_evicts``): drop the N least-
  recently-used unpinned cache parcels from the host tier at the top
  of the next ``step()`` — holes open in the radix tree's host spans
  and refill through recompute, the deterministic driver of the
  tiered cache's degradation tests.

Three REPLICA-level failure modes ride on top (the failover layer of
``inference/router.py`` is tested against these; each models a whole
replica going bad rather than one allocation or one step):

- **kill** (``kill_at_step``): the engine raises a typed
  ``ReplicaKilledError`` at the top of every ``step()`` from the armed
  scheduler step on — LATCHED, like a crashed process that stays dead
  until restarted; ``clear_replica_faults()`` is the restart.
- **poisoned dispatch** (``poison_at_step``): ONE decode-block harvest
  at-or-after the armed step materializes corrupted outputs (the
  engine's harvest validation then raises ``PoisonedDispatchError``) —
  the int-token-stream analogue of a device returning non-finite
  logits.  Transient: the fault consumes itself, so a restarted
  replica probes healthy.
- **permanent stall** (``stall_forever``): every ``step()`` raises
  ``EngineStalledError`` immediately — the watchdog's view of a
  dispatch that never returns — until ``clear_replica_faults()``.

The injector is pure host state with no engine back-references: one
injector can be armed before the engine exists and inspected after it
is gone.  ``events`` records every fault that actually FIRED (armed
faults that never triggered do not appear), so tests can assert the
schedule they meant to inject is the schedule the engine saw.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple


class FaultInjector:
    """Deterministic fault schedule consumed by ``ServingEngine``.

    All ``take_*`` methods are called BY the engine at its hook points
    and consume the armed fault; ``fail_*``/``force_*``/``stall_*``
    methods are called by the test to arm them.  Thread-unsafe by
    design: the scheduler is single-threaded host code and the tests
    drive it synchronously.
    """

    def __init__(self):
        self._alloc_budget = 0        # finite failures left
        self._alloc_always = False
        self._swapin_budget = 0       # finite swap-in failures left
        self._swapin_always = False
        self._tier_evicts = 0         # forced cache evictions pending
        self._forced: List[int] = []  # request ids to preempt
        self._stalls: deque = deque()  # seconds, one per upcoming step
        # replica-level faults (router-failover drivers)
        self._kill_at: Optional[int] = None     # latched from this step
        self._poison_at: Optional[int] = None   # one-shot from this step
        self._stall_forever = False             # latched until cleared
        self._exit_at: Optional[int] = None     # process death
        self.events: List[Tuple[str, Optional[int]]] = []

    # -- arming (test side) --
    def fail_allocs(self, n: Optional[int] = None):
        """Make the engine's next ``n`` block allocations fail as if
        the pool were exhausted; ``n=None`` fails EVERY allocation
        until ``clear_alloc_failures()``."""
        if n is None:
            self._alloc_always = True
        else:
            if int(n) < 1:
                raise ValueError(f"n must be >= 1 allocs, got {n}")
            self._alloc_budget += int(n)

    def clear_alloc_failures(self):
        self._alloc_budget = 0
        self._alloc_always = False

    def fail_swapins(self, n: Optional[int] = None):
        """Make the engine's next ``n`` prefix-cache host-tier
        swap-ins fail at admission (``n=None`` fails EVERY one until
        ``clear_swapin_failures()``): the host parcels drop and the
        match degrades to its directly mapped HBM prefix — the tail
        recomputes."""
        if n is None:
            self._swapin_always = True
        else:
            if int(n) < 1:
                raise ValueError(f"n must be >= 1 swap-ins, got {n}")
            self._swapin_budget += int(n)

    def clear_swapin_failures(self):
        self._swapin_budget = 0
        self._swapin_always = False

    def force_tier_evicts(self, n: int):
        """Drop the ``n`` least-recently-used unpinned cache parcels
        from the host tier at the top of the next ``step()`` —
        punches holes in the radix tree's host-resident spans."""
        if int(n) < 1:
            raise ValueError(f"n must be >= 1 evictions, got {n}")
        self._tier_evicts += int(n)

    def force_swap(self, request_id: int):
        """Preempt the given in-flight request (swap its KV blocks to
        the host tier) at the top of the next ``step()``, regardless
        of pool pressure or scheduling class.  Unknown / not-in-flight
        ids are silently skipped by the engine — arming is a schedule,
        not an assertion."""
        self._forced.append(int(request_id))

    def kill_at_step(self, step: int):
        """Kill the replica from scheduler step ``step`` on: every
        ``step()`` whose index is >= ``step`` raises
        ``ReplicaKilledError`` at the top, before any scheduling work.
        LATCHED — a crashed process stays dead until the operator
        restarts it (``clear_replica_faults``); a router probe against
        a still-dead replica keeps failing, which is the point."""
        if int(step) < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self._kill_at = int(step)

    def poison_at_step(self, step: int):
        """Poison ONE decode-block harvest at-or-after scheduler step
        ``step``: the engine materializes corrupted outputs and its
        harvest validation raises ``PoisonedDispatchError`` — the
        deterministic stand-in for a dispatch that came back with
        non-finite logits.  One-shot: a restarted replica is healthy
        (transient device fault), unlike the latched kill/stall."""
        if int(step) < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self._poison_at = int(step)

    def exit_at_step(self, step: int):
        """Arm a REAL process death at scheduler step ``step``: the
        process-side serving host (``procserve.EngineHost``) consumes
        this with ``take_exit`` before dispatching the step and dies
        with ``os._exit`` — no teardown, no exception, no goodbye
        frame.  The engine itself never sees the fault: unlike
        ``kill_at_step`` (an in-process stand-in for a crash), this IS
        the crash, and the parent router only learns of it as a dead
        socket (``TransportDeadError``).  Deterministic by
        construction — the death lands on a chosen scheduler step, not
        on a parent-side kill racing the child's event loop."""
        if int(step) < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self._exit_at = int(step)

    def stall_forever(self):
        """Make EVERY ``step()`` raise ``EngineStalledError``
        immediately (a permanently wedged dispatch, as the watchdog
        sees it) until ``clear_replica_faults()``."""
        self._stall_forever = True

    def clear_replica_faults(self):
        """The replica 'restart': clears the latched kill/stall and
        any un-fired poison, so the next router probe can pass."""
        self._kill_at = None
        self._poison_at = None
        self._stall_forever = False

    def arm_replica_fault(self, kind: str, step: int = 1):
        """Arm one replica fault by name — the seeded-schedule
        convenience (a soak test draws ``kind``/``step`` from a seeded
        RNG and arms them here)."""
        if kind == "kill":
            self.kill_at_step(step)
        elif kind == "poison":
            self.poison_at_step(step)
        elif kind == "stall":
            self.stall_forever()
        else:
            raise ValueError(
                f"unknown replica fault {kind!r} — known: "
                f"kill / poison / stall")

    def stall_steps(self, n: int, seconds: float):
        """Make the next ``n`` ``step()`` calls sleep ``seconds``
        before any scheduling work — an artificial wedged-dispatch
        stand-in for ``run(wall_timeout_s=...)`` tests."""
        if int(n) < 1:
            raise ValueError(f"n must be >= 1 steps, got {n}")
        if float(seconds) < 0:
            raise ValueError(f"seconds must be >= 0, got {seconds}")
        self._stalls.extend([float(seconds)] * int(n))

    # -- consumption (engine side) --
    def take_alloc_failure(self) -> bool:
        """True when THIS allocation should fail (consumes one armed
        failure unless armed with ``n=None``)."""
        if self._alloc_always:
            self.events.append(("alloc_fail", None))
            return True
        if self._alloc_budget > 0:
            self._alloc_budget -= 1
            self.events.append(("alloc_fail", None))
            return True
        return False

    def take_swapin_failure(self) -> bool:
        """True when THIS admission's host-tier swap-in should fail
        (consumes one armed failure unless armed with ``n=None``)."""
        if self._swapin_always:
            self.events.append(("swapin_fail", None))
            return True
        if self._swapin_budget > 0:
            self._swapin_budget -= 1
            self.events.append(("swapin_fail", None))
            return True
        return False

    def take_tier_evicts(self) -> int:
        """Forced cache-parcel evictions to apply this step (consumes
        them).  The engine evicts at most as many unpinned parcels as
        the tier actually holds and reports the applied count back via
        ``record_tier_evicts`` — events record faults that FIRED, not
        merely armed ones (the module contract)."""
        n, self._tier_evicts = self._tier_evicts, 0
        return n

    def record_tier_evicts(self, n: int):
        """Engine-side report of forced evictions actually applied."""
        for _ in range(int(n)):
            self.events.append(("tier_evict", None))

    def take_forced_swaps(self) -> List[int]:
        """Request ids to force-preempt this step (consumes them)."""
        out, self._forced = self._forced, []
        for rid in out:
            self.events.append(("forced_swap", rid))
        return out

    def take_kill(self, step_idx: int) -> bool:
        """True when THIS step should raise ``ReplicaKilledError``
        (latched: keeps returning True until the restart clears it)."""
        if self._kill_at is not None and int(step_idx) >= self._kill_at:
            self.events.append(("kill", None))
            return True
        return False

    def take_poison(self, step_idx: int) -> bool:
        """True when THIS decode harvest should materialize corrupted
        outputs (one-shot: consumed on fire)."""
        if self._poison_at is not None \
                and int(step_idx) >= self._poison_at:
            self._poison_at = None
            self.events.append(("poison", None))
            return True
        return False

    def take_exit(self, step_idx: int) -> bool:
        """True when the serving host should ``os._exit`` BEFORE
        running this step (latched — though the process is normally
        gone after the first True)."""
        if self._exit_at is not None and int(step_idx) >= self._exit_at:
            self.events.append(("exit", None))
            return True
        return False

    def take_permanent_stall(self) -> bool:
        """True when THIS step should raise ``EngineStalledError``
        (latched until the restart clears it)."""
        if self._stall_forever:
            self.events.append(("perma_stall", None))
            return True
        return False

    def take_stall(self) -> float:
        """Seconds THIS step should stall (0.0 = no stall armed)."""
        if not self._stalls:
            return 0.0
        s = self._stalls.popleft()
        self.events.append(("stall", None))
        return s
