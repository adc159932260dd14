"""Automatic inference of storage-bandwidth constraints (paper §3.3, §4.2.3).

One :class:`AutoTuner` exists per auto-constrained task *signature* (the
paper assumes an I/O task produces the same workload for the whole run and
runs a separate learning phase per task). The tuner walks *learning epochs*:

* an epoch uses one constraint value ``c`` and admits up to
  ``k = min(floor(B / c), io_executors)`` concurrent tasks on the dedicated
  *active-learning node*;
* the epoch ends when every admitted task has completed; its average task
  time is recorded;
* **bounded** ``auto(min,max,delta)``: c walks min -> max multiplying by
  delta, every epoch is registered;
* **unbounded** ``auto``: c starts at ``max(1, floor(B / io_executors))`` and
  doubles; the phase continues only while ``t_i <= t_{i-1} / 2`` — the
  violating epoch is *not* registered.

After the phase, :meth:`choose` applies the objective function
``T(n, c) = ceil(n / k_c) * t_c`` (remainder counts as one extra execution
group, per paper §4.2.3C) and returns the registered constraint minimising
it; ties go to the highest constraint (least congestion). ``choose`` is
re-evaluated every time new requests arrive, so the constraint tracks the
pending-task count.

Drift adaptation (interference-aware tuning)
--------------------------------------------
The learned ``t_c`` values are a snapshot of the device *as it behaved
during calibration*. On shared tiers a co-tenant (interference.py) changes
the effective device over time, so the curve goes stale. With a
:class:`DriftConfig`, the tuner keeps a sliding window of
observed-vs-predicted time ratios for steady-phase tasks
(:meth:`AutoTuner.observe`); when the window's median leaves
``[1/threshold, threshold]`` the tuner **re-enters calibration** over the
constraints it already measured, blending each re-measured epoch with the
decayed stale value (``prior_weight``) instead of either trusting the
isolated fit or discarding history outright. The scheduler sees
``learning() == True`` again and re-runs the usual isolated learning-node
protocol — on the *interfered* device, which is the point.
"""
from __future__ import annotations

import enum
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .constraints import AutoSpec
from .storage_model import max_concurrent_tasks


@dataclass(frozen=True)
class DriftConfig:
    """Windowed observed-vs-predicted drift detector parameters.

    ``window`` steady-phase observations are kept per tuner (ratios of
    observed task time to the registry's prediction for the granted
    constraint); once at least ``min_observations`` are present and their
    median exceeds ``threshold`` (slower: congestion appeared) or falls
    below ``1/threshold`` (faster: congestion went away), the tuner
    re-enters calibration. Each re-measured constraint is blended as
    ``(1 - prior_weight) * new + prior_weight * stale``.
    """

    window: int = 12
    min_observations: int = 6
    threshold: float = 1.6
    prior_weight: float = 0.25
    #: ``"all"`` re-measures every registered constraint (a full, slower
    #: re-walk); ``"active"`` re-measures only the constraint whose
    #: observations drifted — one epoch, so the tuner tracks regime flips
    #: (bursty on/off co-tenants) without stalling its class for a full
    #: calibration each time
    recal_scope: str = "active"
    #: under the cross-tier objective, every Nth steady grant probes the
    #: runner-up tier so abandoned tiers keep producing observations (an
    #: argmin with no fresh data can never drift back)
    probe_every: int = 8

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not (1 <= self.min_observations <= self.window):
            raise ValueError(
                f"min_observations must be in [1, window={self.window}], "
                f"got {self.min_observations}")
        if self.threshold <= 1.0:
            raise ValueError(
                f"threshold must exceed 1.0 (a ratio of 1 means the curve "
                f"is exact), got {self.threshold}")
        if not (0.0 <= self.prior_weight < 1.0):
            raise ValueError(
                f"prior_weight must be in [0, 1), got {self.prior_weight}")
        if self.recal_scope not in ("all", "active"):
            raise ValueError(
                f"recal_scope must be 'all' or 'active', got "
                f"{self.recal_scope!r}")
        if self.probe_every < 2:
            raise ValueError(
                f"probe_every must be >= 2 (1 would always probe), got "
                f"{self.probe_every}")


class Phase(enum.Enum):
    LEARNING = "learning"
    DONE = "done"


@dataclass
class Epoch:
    constraint: float
    target_k: int
    admitted: int = 0
    completed: int = 0
    total_time: float = 0.0
    closed_admission: bool = False

    @property
    def avg_time(self) -> float:
        return self.total_time / self.completed if self.completed else float("inf")

    def full(self) -> bool:
        return self.closed_admission or self.admitted >= self.target_k

    def done(self) -> bool:
        return (self.closed_admission or self.admitted >= self.target_k) \
            and self.completed >= self.admitted and self.admitted > 0


class AutoTuner:
    """Learning-phase driver + objective function for one task signature."""

    def __init__(self, signature: str, spec: AutoSpec, device_bw: float,
                 io_executors: int, drift: Optional[DriftConfig] = None):
        self.signature = signature
        self.spec = spec
        self.device_bw = float(device_bw)
        self.io_executors = int(io_executors)
        self.registry: dict[float, float] = {}   # constraint -> avg task time
        self.phase = Phase.LEARNING
        self.history: list[tuple[float, float]] = []  # (constraint, avg) per epoch
        if spec.bounded:
            start = float(spec.min)
        else:
            start = float(max(1, int(self.device_bw // max(1, self.io_executors))))
        self.epoch = self._new_epoch(start)
        self._last_choice: Optional[float] = None
        self._choice_counts: dict[float, int] = {}
        self._draining = False
        # drift adaptation (None: steady-phase observations are ignored and
        # behaviour is exactly the static paper tuner)
        self.drift = drift
        self._obs: deque = deque(maxlen=drift.window if drift else 1)
        self.n_recalibrations = 0
        self._recal_schedule: Optional[list[float]] = None  # constraints to
        #                                                     re-measure
        self._recal_idx = 0
        self._stale_prior: dict[float, float] = {}

    # -- epoch machinery ------------------------------------------------------
    def _k_for(self, c: float) -> int:
        return min(max_concurrent_tasks(self.device_bw, c), self.io_executors)

    def _new_epoch(self, c: float) -> Epoch:
        return Epoch(constraint=c, target_k=self._k_for(c))

    def learning(self) -> bool:
        return self.phase == Phase.LEARNING

    def current_constraint(self) -> float:
        return self.epoch.constraint

    def admit(self) -> bool:
        """Try to admit one task into the current epoch. Returns False when
        the epoch is full (the task must wait for the next epoch)."""
        if not self.learning() or self.epoch.full():
            return False
        self.epoch.admitted += 1
        return True

    def on_task_complete(self, duration: float) -> None:
        """Called by the scheduler when an epoch-member task finishes."""
        e = self.epoch
        e.completed += 1
        e.total_time += duration
        if e.done():
            self._advance()

    def end_of_stream(self) -> None:
        """No more tasks of this signature will arrive (barrier/shutdown):
        close admission so a partially-filled epoch can still conclude."""
        if not self.learning():
            return
        self._draining = True
        e = self.epoch
        e.closed_admission = True
        if e.admitted == 0:
            # nothing ran in this epoch; finish with whatever is registered
            self._finish()
        elif e.done():
            self._advance()

    def _advance(self) -> None:
        e = self.epoch
        self.history.append((e.constraint, e.avg_time))
        if self._recal_schedule is not None:
            # drift recalibration: re-measure the constraints already in
            # the registry, blending each with its decayed stale prior
            self._register_measurement(e.constraint, e.avg_time)
            self._recal_idx += 1
            if self._draining or self._recal_idx >= len(self._recal_schedule):
                self._finish()
            else:
                self.epoch = self._new_epoch(
                    self._recal_schedule[self._recal_idx])
            return
        if self._draining:
            # no more arrivals: register what we measured and conclude
            self.registry[e.constraint] = e.avg_time
            self._finish()
            return
        if self.spec.bounded:
            self.registry[e.constraint] = e.avg_time
            nxt = e.constraint * self.spec.delta
            if nxt > self.spec.max + 1e-9:
                self._finish()
            else:
                self.epoch = self._new_epoch(nxt)
        else:
            prev = self._prev_registered_time()
            if prev is None:
                self.registry[e.constraint] = e.avg_time
                self.epoch = self._new_epoch(e.constraint * 2.0)
            elif e.avg_time <= prev / 2.0 + 1e-12:
                self.registry[e.constraint] = e.avg_time
                self.epoch = self._new_epoch(e.constraint * 2.0)
            else:
                # continuation condition violated: epoch NOT registered
                self._finish()
        # a new epoch whose k tasks can never run (k==0 impossible; k>=1) is fine

    def _prev_registered_time(self) -> Optional[float]:
        if not self.registry:
            return None
        # last registered epoch time
        last_c = max(self.registry)  # constraints strictly increase over epochs
        return self.registry[last_c]

    def _finish(self) -> None:
        self.phase = Phase.DONE
        self._recal_schedule = None
        self._stale_prior = {}
        if not self.registry:
            # degenerate: nothing learned; fall back to the starting constraint
            self.registry[self.epoch.constraint] = self.epoch.avg_time \
                if self.epoch.completed else 1.0

    # -- drift adaptation (interference-aware tuning) --------------------------
    def _register_measurement(self, c: float, new_avg: float) -> None:
        prior = self._stale_prior.get(c)
        if prior is not None and self.drift is not None \
                and math.isfinite(new_avg):
            w = self.drift.prior_weight
            self.registry[c] = (1.0 - w) * new_avg + w * prior
        else:
            self.registry[c] = new_avg

    def observe(self, constraint: float, duration: float) -> None:
        """Steady-phase feedback: a granted task ran under ``constraint``
        and took ``duration``. Compares against the learned prediction and
        re-enters calibration when the window's median ratio drifts out of
        band. No-op without a :class:`DriftConfig`, while learning, or once
        the stream is draining (recalibrating at a final barrier would
        stall on epochs that can never fill)."""
        if self.drift is None or self.learning() or self._draining:
            return
        pred = self.registry.get(constraint)
        if pred is None or pred <= 0 or duration <= 0:
            return
        self._obs.append(duration / pred)
        cfg = self.drift
        if len(self._obs) < cfg.min_observations:
            return
        med = sorted(self._obs)[len(self._obs) // 2]
        if med > cfg.threshold or med < 1.0 / cfg.threshold:
            self._reenter_calibration(constraint)

    def _reenter_calibration(self, drifted_c: float) -> None:
        """The learned curve went stale: re-measure on the live
        (interfered) device, keeping the old values as a decayed prior.
        Scope per config: every registered constraint, or just the one
        whose observations drifted (cheap enough to track regime flips)."""
        self._obs.clear()
        self.n_recalibrations += 1
        self._stale_prior = dict(self.registry)
        if self.drift.recal_scope == "active" \
                and drifted_c in self.registry:
            self._recal_schedule = [drifted_c]
        else:
            self._recal_schedule = sorted(self.registry)
        self._recal_idx = 0
        self.phase = Phase.LEARNING
        self.epoch = self._new_epoch(self._recal_schedule[0])

    # -- objective function (paper §3.3.2) ------------------------------------
    def objective_time(self, num_tasks: int, c: float) -> float:
        k = self._k_for(c)
        t = self.registry[c]
        if num_tasks <= 0:
            return 0.0
        groups = num_tasks // k
        rem = num_tasks % k
        total = groups * t
        if rem:
            total += t  # remainder estimated as one extra execution group
        return total

    def peek_choice(self, num_tasks: int) -> float:
        """Constraint minimising T(num_tasks, c); ties -> highest c.

        Pure: safe to call on every placement attempt. Bookkeeping happens in
        :meth:`record_choice` only when the placement is actually granted, so
        ``choice_counts`` reflects launched tasks rather than retries."""
        if not self.registry:
            return self.epoch.constraint
        best_c, best_t = None, None
        for c in sorted(self.registry):
            t = self.objective_time(num_tasks, c)
            if best_t is None or t < best_t - 1e-12 or \
                    (abs(t - best_t) <= 1e-12 and c > best_c):
                best_c, best_t = c, t
        return best_c

    def record_choice(self, c: float) -> None:
        self._last_choice = c
        self._choice_counts[c] = self._choice_counts.get(c, 0) + 1

    def choose(self, num_tasks: int) -> float:
        """peek + record in one step (the paper's re-evaluated objective)."""
        c = self.peek_choice(num_tasks)
        self.record_choice(c)
        return c

    def drift_state(self) -> dict:
        """Snapshot of the steady-phase drift window: how many
        observed-vs-predicted ratios are pending and their current median
        (None until the first observation). Pure read — the telemetry
        rollup and the sim-vs-real harness surface it."""
        obs = list(self._obs)
        med = sorted(obs)[len(obs) // 2] if obs else None
        return {"n_obs": len(obs), "median_ratio": med}

    def summary(self) -> dict:
        return {
            "signature": self.signature,
            "phase": self.phase.value,
            "registry": dict(self.registry),
            "history": list(self.history),
            "last_choice": self._last_choice,
            # the constraint used for the bulk of the run (the last choice can
            # differ for a small final backlog — ties go to the highest
            # constraint, paper §4.2.3C / §5.2.1)
            "modal_choice": max(self._choice_counts,
                                key=self._choice_counts.get)
            if self._choice_counts else None,
            "choice_counts": dict(self._choice_counts),
            "n_recalibrations": self.n_recalibrations,
            "drift_enabled": self.drift is not None,
            "drift_window": self.drift_state(),
        }
