"""Self-tuning planner: the policy layer over the plan telemetry (port of
``mpitest_tpu/models/planner.py``, with its names, thresholds and modes).

Per-request **policies** turn the measurements the plan record carries
into the configuration the telemetry says is fastest:

* **algo policy** (:func:`choose`): score the host input profile
  (sortedness / duplicate ratio / key width, the ~1k strided sample the
  plan profiler takes) into a registered policy: sorted input
  short-circuits through the always-on verifier (one O(n) verify IS the
  sort when it passes, and the ladder sorts for real when the strided
  sample lied), near-sorted input takes the one-exchange sample path,
  duplicate-heavy and range-narrow input route to radix up front;
* **cap/margin policy** (:func:`learned_margin`): size the sample
  probe's safety margin from the observed estimate-error distribution
  (the ``actual need / predicted need`` ratios of recent estimate-mode
  ``cap`` decisions in the flight-recorder ring) instead of the hand-set
  ``SAMPLE_NEG_MARGIN``;
* **serve auto-tuning** (:class:`ServeTuner`): the batching window and
  prewarm shape buckets re-sized from the rolling request mix with
  two-phase hysteresis, so an oscillating mix never thrashes the window.
  The class is pure; the server that applies it is not ported yet.

Modes (``SORT_PLANNER``): ``off``, nothing runs; ``shadow``, every policy
is computed and logged as a registered ``planner`` plan decision
(``applied=False``) while the output path stays byte-identical; ``on``,
the policies act.  The always-on verifier and the supervisor ladder make
any bad choice recoverable.

Policy names are registered here (:data:`PLANNER_POLICIES`), like plan
decisions in ``models/plan.py``; ``tests/test_torch_plan_lint.py`` fails
on any literal policy name in the package outside the registry.

Stdlib only at import time; knobs and the flight recorder load lazily
inside functions.
"""

from __future__ import annotations

import collections
import math
import statistics
import threading
from dataclasses import dataclass, field
from typing import Any

#: Version tag of the planner record (stamped into decision attrs).
PLANNER_SCHEMA = "planner.v1"

#: Registered policy vocabulary: name -> one-line doc of what the
#: policy does and when the scorer picks it.  A literal policy name
#: outside this dict fails the package's vocabulary test.
PLANNER_POLICIES: dict[str, str] = {
    "static": ("the hand-set defaults unchanged — the scorer found no "
               "profile signal worth acting on (uniform input, or no "
               "host profile available)"),
    "verify_passthrough": ("profile says the input is already sorted: "
                           "run the always-on verifier on the staged "
                           "input words — one O(n) verify dispatch IS "
                           "the sort when it passes; a miss (the "
                           "strided sample hid a descent) falls "
                           "through to the ordinary ladder"),
    "merge_sample": ("near-sorted input: quantile splitters over "
                     "sorted-ish data are near-perfect, so the single-"
                     "exchange sample path beats the multi-pass radix "
                     "default"),
    "radix_narrow": ("duplicate-heavy / low-entropy input: splitters "
                     "would degenerate, and the measured effective key "
                     "width already cuts the radix pass count — route "
                     "to radix up front (the scored twin of the "
                     "reactive skew_sniff)"),
    "radix_compact": ("range-narrow input: the profile's "
                      "sampled min/max promise few significant key "
                      "bits, so the radix route with its diff-driven "
                      "pass planner (and the fused local engine's "
                      "compacted pass plan) sorts in fewer, narrower "
                      "passes than any comparison path — extends "
                      "radix_narrow from dup-heavy to range-narrow"),
    "cap_margin": ("sample-negotiation margin sized from the observed "
                   "estimate-error quantiles in the flight ring "
                   "instead of the fixed x1.25 constant — the recorded "
                   "policy when the margin learned but the algo scorer "
                   "chose nothing (profile was uniform)"),
    "window_auto": ("serve batching window re-sized from the rolling "
                    "inter-arrival mix (two-phase hysteresis: two "
                    "consecutive agreeing evaluations commit, an "
                    "oscillating mix never flips twice in a row)"),
    "buckets_auto": ("executor-cache prewarm buckets extended from the "
                     "observed request size/dtype mix so the mix's "
                     "shapes compile off the request path (per dtype — "
                     "packed executables are keyed by it)"),
}


def policy(name: str) -> str:
    """Registered-policy lookup: returns the policy's doc line, raises
    ``KeyError`` for unregistered names — the runtime twin of the
    vocabulary test (a policy name that is not in the vocabulary is a bug, not a
    new feature)."""
    return PLANNER_POLICIES[name]


# ----------------------------------------------------------- mode / knobs

def mode() -> str:
    """``SORT_PLANNER`` ∈ {off, shadow, on} (default off — the
    pre-planner stack byte-for-byte).  ``shadow`` computes and logs
    every policy choice without acting; ``on`` acts.

    The planner RIDES the plan-provenance layer (its decisions are
    plan decisions, its margin policy reads plan records from the
    flight ring), so ``SORT_PLAN=off`` disables the planner everywhere
    — this resolver is the one chokepoint: library hook and serve
    tuner both read the same effective mode, and the ``SORT_PLAN=off``
    contract ("no sort.plan spans") can never be violated by a
    planner half-running."""
    from mpitest_tpu_torch.models import plan as plan_mod
    from mpitest_tpu_torch.utils import knobs

    v = knobs.get("SORT_PLANNER")
    if v != "off" and not plan_mod.enabled():
        return "off"
    return v


def window() -> int:
    """``SORT_PLANNER_WINDOW``: how many recent records/observations
    the learning policies look back over (flight-ring plan records for
    the margin policy, request arrivals for the serve tuner)."""
    from mpitest_tpu_torch.utils import knobs

    return knobs.get("SORT_PLANNER_WINDOW")


def hysteresis() -> float:
    """``SORT_PLANNER_HYSTERESIS``: minimum ratio a serve-tuner
    recommendation must differ from the current value by before it may
    be applied (> 1; applied symmetrically up/down)."""
    from mpitest_tpu_torch.utils import knobs

    return knobs.get("SORT_PLANNER_HYSTERESIS")


# ------------------------------------------------------------ algo policy

#: Profile thresholds of the algo scorer (unit-tested in
#: tests/test_planner.py).  The strided profile's sortedness is the
#: fraction of non-decreasing adjacent sample pairs; dup_ratio the
#: fraction of equal adjacent pairs in the sorted sample.
SORTED_SORTEDNESS = 1.0      # every sampled pair non-decreasing
NEAR_SORTED_SORTEDNESS = 0.9
DUP_RATIO_HEAVY = 0.25
#: Max sampled key width (significant bits of max-min) that counts as
#: range-narrow: 20 bits in an int64 is the canonical case —
#: 3 radix passes instead of 8.  Mirrors the digit math: width/8 passes.
NARROW_KEY_WIDTH_BITS = 20
#: Digit widths the pass prediction considers — the radix default and
#: the wide digit models/api.py's _auto_digit_bits switches to when it
#: cuts the pass count; the prediction mirrors that rule (min passes
#: over both widths) so an honest profile predicts the pass count that
#: actually runs.
NARROW_DIGIT_BITS = 8
NARROW_WIDE_DIGIT_BITS = 16


@dataclass
class PolicyChoice:
    """One scored algo-policy verdict: the registered policy name, the
    profile class that fired (``trigger``), the algorithm override
    (None = keep the requested one), and the predicted quantities the
    plan decision records."""

    policy: str
    trigger: str
    algo: str | None = None
    predicted: dict[str, Any] = field(default_factory=dict)


def choose(profile: dict, requested: str,
           verify_on: bool) -> PolicyChoice:
    """Score the input profile into a registered policy.  Pure function
    of its inputs (unit-testable); empty profiles (device-resident /
    staged input — no host sample was taken) choose ``static``.
    ``requested`` is the algo the caller asked for: a policy whose
    target already equals it returns ``algo=None`` (the policy is
    still recorded, the reroute is a no-op).

    Ordering: fully-sorted first (the passthrough beats everything and
    needs the verifier as its proof), then duplicate-heavy (a near-
    sorted but dup-heavy input would degenerate sample splitters — the
    radix route wins even when sortedness is high), then near-sorted,
    then range-narrow (a near-sorted narrow input still wants the
    single-exchange sample path; compaction only pays on inputs the
    multi-pass radix would run anyway).
    """
    sortedness = profile.get("sortedness")
    dup = profile.get("dup_ratio", 0.0)
    if sortedness is None:
        return PolicyChoice("static", "no_profile")
    if sortedness >= SORTED_SORTEDNESS and verify_on:
        # the verifier is the proof — without it the "sorted" sample is
        # just a guess, and a guess must not skip the sort
        return PolicyChoice("verify_passthrough", "sorted",
                            predicted={"sortedness": sortedness})
    if dup >= DUP_RATIO_HEAVY:
        return PolicyChoice(
            "radix_narrow", "dup_heavy",
            algo=None if requested == "radix" else "radix",
            predicted={"dup_ratio": dup})
    if sortedness >= NEAR_SORTED_SORTEDNESS:
        return PolicyChoice(
            "merge_sample", "near_sorted",
            algo=None if requested == "sample" else "sample",
            predicted={"sortedness": sortedness})
    width = profile.get("key_width")
    if width is not None and 0 < int(width) <= NARROW_KEY_WIDTH_BITS:
        # key-width compaction: predicted passes are what
        # the diff planner will run IF the sampled range held; the
        # "passes" plan decision scores that promise against the pass
        # count actually dispatched (lying-profile regret)
        w = int(width)
        passes = min(-(-w // NARROW_DIGIT_BITS),
                     -(-w // NARROW_WIDE_DIGIT_BITS))
        return PolicyChoice(
            "radix_compact", "range_narrow",
            algo=None if requested == "radix" else "radix",
            predicted={"key_width": w, "passes": passes})
    return PolicyChoice("static", "uniform")


# ------------------------------------------------------ cap/margin policy

#: Bounds of the learned sample-negotiation margin: never below a 2%
#: safety pad (the regrow loop is the backstop, but a regrow costs a
#: full discarded exchange), never above the old worst-case constant
#: territory (an estimator THAT wrong should pay regrows visibly, not
#: hide behind an unbounded margin).
MARGIN_MIN = 1.02
MARGIN_MAX = 2.0

#: Multiplicative pad on the observed q95 error ratio (the 5% tail the
#: quantile did not see still has to fit more often than not).
MARGIN_PAD = 1.03

#: Below this many observed negotiate decisions the margin policy
#: declines to learn and returns the hand-set default.
MARGIN_MIN_SAMPLES = 6

#: Recompute the learned margin only after the flight ring grew by
#: this many spans (the quantile can't move faster than the ring
#: fills) — amortizes the ring scan off the per-request path.
MARGIN_REFRESH = 24

#: Memo of the last computation: (recorder instance, its recorded
#: count at compute time, learned margin or None, evidence).  The
#: identity check recomputes when tests swap the recorder; the count
#: check recomputes after :data:`MARGIN_REFRESH` new spans.
_margin_memo: "tuple[Any, int, float | None, dict[str, Any]] | None" \
    = None


def learned_margin(default: float, last_n: int | None = None,
                   ) -> tuple[float, dict[str, Any]]:
    """The cap/margin policy: the sample probe's safety margin sized
    from the observed estimate-error distribution — the ``actual need /
    predicted need`` ratios of recent estimate-mode ``cap`` decisions
    in the flight-recorder ring (``sort.plan`` spans; the predicted
    side is the raw probe count, so the ratio measures the ESTIMATOR,
    independent of whatever margin past runs applied).  Returns
    ``(margin, evidence)`` where evidence is stamped into the planner
    decision's predicted attrs; with fewer than
    :data:`MARGIN_MIN_SAMPLES` observations the hand-set ``default``
    comes back unchanged (``margin_learned`` False).

    Memoized per :data:`MARGIN_REFRESH` ring growth: at serve QPS the
    ring scan + record decode would otherwise repeat per request for a
    value that only moves as new negotiate decisions accumulate."""
    global _margin_memo
    from mpitest_tpu_torch.utils import flight_recorder

    rec = flight_recorder.get()
    memo = _margin_memo
    if (memo is not None and memo[0] is rec
            and 0 <= rec.recorded - memo[1] < MARGIN_REFRESH):
        return (default if memo[2] is None else memo[2]), dict(memo[3])
    if last_n is None:
        last_n = window()
    rows = rec.snapshot(last_n=last_n, kinds=("sort.plan",))
    ratios: list[float] = []
    for r in rows:
        decs = (r.get("attrs") or {}).get("decisions")
        if not isinstance(decs, dict):
            continue
        cap = decs.get("cap")
        if not isinstance(cap, dict) or cap.get("trigger") != "estimate":
            continue
        pred = (cap.get("predicted") or {}).get("need")
        act = (cap.get("actual") or {}).get("need")
        try:
            if pred and act and float(pred) > 0:
                ratios.append(float(act) / float(pred))
        except (TypeError, ValueError):
            continue
    if len(ratios) < MARGIN_MIN_SAMPLES:
        ev = {"margin_samples": len(ratios), "margin_learned": False}
        _margin_memo = (rec, rec.recorded, None, ev)
        return default, dict(ev)
    ratios.sort()
    q95 = ratios[min(len(ratios) - 1,
                     max(0, math.ceil(0.95 * len(ratios)) - 1))]
    m = min(max(q95 * MARGIN_PAD, MARGIN_MIN), MARGIN_MAX)
    ev = {"margin_samples": len(ratios), "margin_learned": True,
          "margin_q95": round(q95, 4)}
    _margin_memo = (rec, rec.recorded, m, ev)
    return m, dict(ev)


# ------------------------------------------------------- serve auto-tuner

#: Evaluate the mix every this many observations (the tuner's cost is
#: one median over the rolling window, amortized far off the hot path).
RETUNE_EVERY = 24

#: Below this many observations the tuner declines to recommend.
MIN_OBSERVATIONS = 16

#: The window recommendation: enough to collect ~this many arrivals
#: at the observed median gap (a closed-loop burst packs into one
#: dispatch; sparse traffic earns a short window and low latency).
WINDOW_GAIN = 4.0

#: Clamp of the recommended batching window, seconds.  The floor keeps
#: latency sane on pathological gap estimates; the ceiling keeps the
#: tuner from ever holding a request longer than a human-visible blink.
MIN_WINDOW_S = 1e-3
MAX_WINDOW_S = 16e-3

#: Gaps above this are idle pauses, not traffic cadence — clipped so
#: one quiet minute cannot drag the median into absurdity.
MAX_GAP_S = 1.0


class ServeTuner:
    """Rolling-mix observer + two-phase hysteresis for the serve layer.

    Handler threads call :meth:`observe` per admitted request (one
    deque append under a lock); every :data:`RETUNE_EVERY` observations
    the caller runs :meth:`evaluate`, which recommends a batching
    window from the observed inter-arrival gaps and size quantiles and
    decides — under the two-phase hysteresis contract — whether to
    commit it:

    * a recommendation inside the hysteresis band of the current value
      is a ``hold`` (and clears any pending direction);
    * the FIRST out-of-band recommendation in a direction is a ``hold``
      that arms that direction;
    * the SECOND consecutive out-of-band recommendation in the SAME
      direction commits (``retune``) and clears the armed state.

    Corollary (regression-tested): an oscillating mix whose successive
    evaluations disagree in direction never commits at all, and no two
    consecutive evaluations can both commit — the window cannot thrash.

    The tuner tracks its own committed window (``window_s``) so shadow
    mode can log would-have-been retunes over time without ever
    touching the live batcher; the serve layer applies ``window_s`` to
    the batcher only in ``on`` mode.
    """

    def __init__(self, window: int, hysteresis: float,
                 batch_keys: int, initial_window_s: float) -> None:
        self.capacity = max(int(window), MIN_OBSERVATIONS)
        self.hysteresis = float(hysteresis)
        self.batch_keys = int(batch_keys)
        self.window_s = float(initial_window_s)
        self._arrivals: "collections.deque[float]" = collections.deque(
            maxlen=self.capacity)
        self._sizes: "collections.deque[int]" = collections.deque(
            maxlen=self.capacity)
        self._dtypes: "collections.deque[str]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._since_eval = 0
        self._pending_dir: str | None = None
        self.evals = 0
        self.retunes = 0
        self.last: dict[str, Any] = {}

    def observe(self, t_arrival: float, n: int,
                dtype_name: str = "int32") -> bool:
        """Record one admitted request; True when an evaluation is due
        (every :data:`RETUNE_EVERY` observations).  ``dtype_name``
        feeds the prewarm recommendation — a packed executable is
        keyed per dtype, so an int32 build never covers a uint64 mix."""
        with self._lock:
            self._arrivals.append(float(t_arrival))
            self._sizes.append(int(n))
            self._dtypes.append(str(dtype_name))
            self._since_eval += 1
            if self._since_eval >= RETUNE_EVERY:
                self._since_eval = 0
                return True
        return False

    def _recommend_locked(self) -> dict[str, Any] | None:
        if len(self._arrivals) < MIN_OBSERVATIONS:
            return None
        arr = list(self._arrivals)
        gaps = [min(b - a, MAX_GAP_S)
                for a, b in zip(arr, arr[1:]) if b >= a]
        if not gaps:
            return None
        p50_gap = statistics.median(gaps)
        desired = min(max(WINDOW_GAIN * p50_gap, MIN_WINDOW_S),
                      MAX_WINDOW_S)
        sizes = sorted(self._sizes)
        # clamp to the batch bound: over-batch_keys requests dispatch
        # solo and never touch a packed executable, so their sizes must
        # not steer the prewarm toward buckets no batch can ever use
        p99_n = min(sizes[min(len(sizes) - 1,
                              max(0, math.ceil(0.99 * len(sizes)) - 1))],
                    self.batch_keys)
        # the packed total a full window would plausibly collect: the
        # p99 request times the arrivals one window spans, capped at
        # the batch-keys bound — the bucket this mix actually needs
        expect = min(self.batch_keys,
                     int(p99_n * max(1.0, desired / max(p50_gap, 1e-6))))
        return {"window_s": round(desired, 6),
                "p50_gap_s": round(p50_gap, 6),
                "p99_n": int(p99_n),
                "expected_batch_keys": int(expect),
                "dtypes": tuple(sorted(set(self._dtypes)))}

    def evaluate(self) -> tuple[str, dict[str, Any]] | None:
        """Recommend-and-maybe-commit (see class docstring).  Returns
        ``None`` (not enough data), ``("hold", rec)`` or
        ``("retune", rec)`` — on retune, ``self.window_s`` already
        carries the committed value."""
        with self._lock:
            rec = self._recommend_locked()
            if rec is None:
                return None
            self.evals += 1
            self.last = rec
            desired = float(rec["window_s"])
            cur = self.window_s
            ratio = desired / cur if cur > 0 else math.inf
            if 1.0 / self.hysteresis < ratio < self.hysteresis:
                self._pending_dir = None
                return ("hold", rec)
            direction = "up" if desired > cur else "down"
            if self._pending_dir != direction:
                # phase one: arm the direction, commit nothing yet
                self._pending_dir = direction
                return ("hold", rec)
            # phase two: the second consecutive agreeing evaluation
            self._pending_dir = None
            self.window_s = desired
            self.retunes += 1
            return ("retune", rec)

    def snapshot(self) -> dict[str, Any]:
        """Consistent point-in-time state for ``/varz``."""
        with self._lock:
            return {"window_s": self.window_s,
                    "observations": len(self._arrivals),
                    "evals": self.evals,
                    "retunes": self.retunes,
                    "pending_dir": self._pending_dir,
                    "hysteresis": self.hysteresis,
                    "last": dict(self.last)}
