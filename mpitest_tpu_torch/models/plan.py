"""Plan provenance: the typed record of every runtime decision a sort makes
(port of ``mpitest_tpu/models/plan.py``, with its names, registries and
regret rule).

A :class:`SortPlan` is minted at the decision chokepoints
(``models/api.py``, ``models/supervisor.py``, ``store/external.py``):
each decision carries the **predicted** quantity at decision time and the
**actual** one stamped at completion, folded into a ``regret`` scalar per
decision, so a mis-sized cap, a wasted re-stage or a wrong reroute is a
number on the ``sort.plan`` span and one line in ``report.py --explain``.

The decision vocabulary is registered here (:data:`PLAN_DECISIONS`), like
span names in ``utils/span_schema.py``: ``report.py --explain`` keys on
these strings, and ``tests/test_torch_plan_lint.py`` fails on any literal
decision name in the package outside the registry (the reference's
sortlint rule SL005).

Regret semantics: regret is a unitless scalar >= 0 per decision.  0 means
the prediction matched reality and the decision cost nothing it did not
have to; each avoidable full re-dispatch (overflow regrow, wasted
re-stage, late reroute, ladder descent) costs 1.0; sizing decisions add
their relative prediction error ``|predicted - actual| / max(actual, 1)``.
The plan's total regret is the sum over decisions.

Stdlib only at import time; numpy loads lazily inside the profiler
functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

#: Version tag of the plan record (the ``sort.plan`` span's ``plan_v``).
PLAN_SCHEMA = "plan.v1"

#: Registered decision vocabulary: name -> one-line doc of what was
#: decided and who decides it.  A literal ``plan.decide(...)`` /
#: ``plan.actual(...)`` name outside this dict fails the package's
#: vocabulary test.
PLAN_DECISIONS: dict[str, str] = {
    "algo": ("sort algorithm actually run vs requested (skew reroutes: "
             "sniff / probe-estimate / reactive cap-exceeded)"),
    "cap": ("exchange capacity: negotiation mode (exact/estimate/off), "
            "chosen cap vs probe-predicted need vs measured need; "
            "overflow regrows stamped by the supervisor"),
    "restage": ("skew-aware re-stage verdict + trigger (probe/overflow); "
                "predicted vs post-restage peer ratio"),
    "engine": ("exchange-pack and local-sort engine selection "
               "(xla/pallas pack, lax/bitonic/radix_pallas local); a "
               "local-engine degrade (trigger=pallas_fault for "
               "dispatch faults, verify_failure for failed "
               "verification) is this decision's regret, beside the "
               "pair-residual fallbacks"),
    "exchange_engine": ("inter-device exchange engine: "
                        "lax collective vs pallas remote-DMA + fused "
                        "pass; a degrade to lax (trigger=pallas_fault "
                        "for dispatch faults, verify_failure for "
                        "failed verification) is this decision's "
                        "regret"),
    "passes": ("radix pass plan: digit width + pass count from the "
               "word-diff planner vs passes actually dispatched"),
    "ladder": ("fallback-ladder rung the result came from; descents "
               "and supervisor dispatch retries are its regret"),
    "batch": ("serve batching: window close reason, members packed, "
              "bucket chosen; predicted vs actual padded-lane waste"),
    "planner": ("self-tuning planner verdict: the scored "
                "policy (models/planner.py PLANNER_POLICIES), "
                "its profile trigger, whether it was applied (on) or "
                "only logged (shadow), the learned margin evidence; a "
                "passthrough miss (the strided profile lied and the "
                "verify pass was wasted) is this decision's regret"),
    "external": ("out-of-core tier verdict: the request "
                 "spilled to sorted runs + k-way merge under "
                 "SORT_MEM_BUDGET (predicted budget/fan-in vs actual "
                 "runs/disk bytes/merge passes); each integrity "
                 "recovery — a re-spilled run + re-merge — is this "
                 "decision's regret"),
}

#: Registered input-distribution profile fields (the probe-riding
#: profiler's vocabulary — recorded on the plan and the sort.plan span).
PLAN_PROFILE_FIELDS: tuple[str, ...] = (
    "sortedness", "run_len", "dup_ratio", "bin_entropy", "skew_factor",
    "key_width")


def relative_regret(predicted: float, actual: float) -> float:
    """The sizing-regret rule: relative prediction error, floored so a
    tiny actual cannot blow the ratio up (``|p - a| / max(|a|, 1)``)."""
    return abs(float(predicted) - float(actual)) / max(abs(float(actual)),
                                                       1.0)


def _scalar(v: Any) -> Any:
    """JSON-safe scalar: numpy ints/floats/bools degrade to Python ones
    (span attrs stream as JSON; an int64 leaking in would crash the
    JSONL append mid-sort)."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return round(v, 6)
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _scalar(item())
        except Exception:  # noqa: BLE001 — telemetry must not raise
            return str(v)
    return str(v)


def _clean(d: dict[str, Any]) -> dict[str, Any]:
    return {k: _scalar(v) for k, v in d.items() if v is not None}


@dataclass
class Decision:
    """One recorded decision: what was chosen (vs requested), why
    (``trigger``), what was predicted at decision time, and what
    actually happened — with the folded ``regret`` scalar."""

    name: str
    chosen: Any = None
    requested: Any = None
    trigger: str | None = None
    predicted: dict[str, Any] = field(default_factory=dict)
    actual: dict[str, Any] = field(default_factory=dict)
    regret: float | None = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"chosen": _scalar(self.chosen)}
        if self.requested is not None:
            out["requested"] = _scalar(self.requested)
        if self.trigger is not None:
            out["trigger"] = self.trigger
        if self.predicted:
            out["predicted"] = _clean(self.predicted)
        if self.actual:
            out["actual"] = _clean(self.actual)
        if self.regret is not None:
            out["regret"] = round(float(self.regret), 6)
        return out


class SortPlan:
    """The per-run decision record.  Minted once per sort (or per
    packed serve dispatch), carried on the run's ``Tracer``; decisions
    accumulate through :meth:`decide` / :meth:`actual`, and
    :meth:`finalize` folds the per-decision regrets.  All methods are
    no-fail by contract — provenance must never take down the sort it
    describes."""

    def __init__(self, algo: str | None = None, n: int | None = None,
                 dtype: str | None = None, ranks: int | None = None,
                 ) -> None:
        self.algo = algo
        self.n = n
        self.dtype = dtype
        self.ranks = ranks
        self.decisions: dict[str, Decision] = {}
        self.profile: dict[str, float] = {}
        self.finalized = False
        #: snapshot of a cumulative tracer counter at mint time — the
        #: minting layer records it so completion stamps per-run deltas
        #: (a reused serve tracer accumulates across requests).
        self.fallbacks_base = 0

    # -- recording ----------------------------------------------------
    def decide(self, name: str, chosen: Any, requested: Any = None,
               trigger: str | None = None, **predicted: Any) -> Decision:
        """Record (or re-record — a reroute overwrites ``chosen`` /
        ``trigger`` while keeping earlier predictions) one decision.
        ``name`` must come from :data:`PLAN_DECISIONS`."""
        d = self.decisions.get(name)
        if d is None:
            d = self.decisions[name] = Decision(name)
        d.chosen = chosen
        if requested is not None:
            d.requested = requested
        if trigger is not None:
            d.trigger = trigger
        d.predicted.update(predicted)
        if name == "algo" and isinstance(chosen, str):
            # the plan's headline algo is the one that RAN: a reroute
            # must update the span head / digest / by-algo census, not
            # just the decision row (the requested algo stays on it)
            self.algo = chosen
        return d

    def actual(self, name: str, **measured: Any) -> None:
        """Stamp measured outcomes onto a decision at completion (merge
        semantics; later stamps win per key).  Stamping a decision that
        was never made records the measurement alone — the explain view
        shows it as an outcome without a recorded choice, which is
        itself a provenance finding."""
        d = self.decisions.get(name)
        if d is None:
            d = self.decisions[name] = Decision(name)
        d.actual.update(measured)

    def bump(self, name: str, key: str, amount: float = 1.0) -> None:
        """Accumulate a counter-like actual (e.g. supervisor regrows /
        retries) — merge-overwrite semantics would lose earlier
        increments."""
        d = self.decisions.get(name)
        if d is None:
            d = self.decisions[name] = Decision(name)
        d.actual[key] = float(d.actual.get(key, 0)) + amount

    # -- regret folding ----------------------------------------------
    def _regret_of(self, d: Decision) -> float:
        """The per-decision regret rule (see module docstring)."""
        p, a = d.predicted, d.actual
        if d.name == "cap":
            # sizing error vs the measured need + one unit per overflow
            # regrow (each is a full discarded exchange dispatch).  With
            # negotiation OFF the cap machinery could neither see nor
            # fix the exchange imbalance, so the whole need-above-fair
            # overhead is this decision's regret too — that is exactly
            # the term SORT_NEGOTIATE=off raises on a skewed input
            # (when a probe ran, the imbalance is the restage
            # decision's to answer for, and cap regret is pure sizing).
            regrows = float(a.get("regrows", 0) or 0)
            cap = p.get("cap")
            need = a.get("need", p.get("need"))
            r = regrows
            if cap is not None and need is not None:
                r += relative_regret(float(cap), float(need))
            if d.trigger == "off":
                fair = p.get("fair")
                if fair and need is not None:
                    r += max(0.0, float(need) / float(fair) - 1.0)
            return r
        if d.name == "restage":
            if d.chosen:
                # a re-stage that did not improve the peer ratio was a
                # wasted full resharding pass
                before = p.get("peer_ratio")
                after = a.get("peer_ratio")
                if before is not None and after is not None \
                        and float(after) >= float(before):
                    return 1.0
                return 0.0
            # not restaged: the overflow cost is already charged to the
            # cap decision (regrows) — no double count here
            return 0.0
        if d.name == "algo":
            # a LATE reroute paid a doomed full exchange before
            # switching; an up-front one (sniff/probe) costs nothing
            return 1.0 if a.get("late_reroute") else 0.0
        if d.name == "passes":
            planned = p.get("passes", d.chosen)
            ran = a.get("passes")
            if planned is not None and ran is not None:
                return relative_regret(float(planned), float(ran))
            return 0.0
        if d.name == "ladder":
            return (float(a.get("rungs_descended", 0) or 0)
                    + float(a.get("dispatch_retries", 0) or 0))
        if d.name == "batch":
            # padded lanes are pure overhead; the prediction error on
            # top shows a window that closed on stale information
            waste = float(a.get("waste", p.get("waste", 0.0)) or 0.0)
            pred = p.get("waste")
            extra = (relative_regret(float(pred), waste)
                     if pred is not None and "waste" in a else 0.0)
            return waste + extra
        if d.name == "engine":
            # an engine whose residual fallback ran paid both engines;
            # a local-engine ladder degrade (fused radix -> lax, same
            # trigger classes as exchange_engine) paid every dispatch
            # up to the switch on top
            return (float(a.get("fallbacks", 0) or 0)
                    + (1.0 if d.trigger in ("pallas_fault",
                                            "verify_failure") else 0.0))
        if d.name == "planner":
            # the planner's own cost: each passthrough miss paid one
            # verify dispatch that proved nothing (the strided profile
            # hid a descent) before the ladder sorted for real.  A
            # shadow decision (applied False) changed nothing and can
            # regret nothing.
            return float(a.get("misses", 0) or 0)
        if d.name == "external":
            # each recovery paid one blamed-run re-spill + a full
            # re-merge before the verified result
            return float(a.get("recoveries", 0) or 0)
        if d.name == "exchange_engine":
            # either degrade cause paid every dispatch up to the switch
            # before the lax rung re-ran the whole algorithm; the
            # trigger names the cause class (kernel fault vs failed
            # verification, which may equally implicate the data)
            return 1.0 if d.trigger in ("pallas_fault",
                                        "verify_failure") else 0.0
        return 0.0

    def finalize(self) -> float:
        """Fold per-decision regrets; returns the plan's total regret.
        Idempotent (re-finalizing re-folds from the current stamps)."""
        total = 0.0
        for d in self.decisions.values():
            try:
                d.regret = round(self._regret_of(d), 6)
            except (TypeError, ValueError):
                d.regret = 0.0
            total += d.regret
        self.total_regret = round(total, 6)
        self.finalized = True
        return self.total_regret

    # -- export -------------------------------------------------------
    def to_attrs(self) -> dict[str, Any]:
        """The ``sort.plan`` span's attrs: everything, JSON-safe."""
        if not self.finalized:
            self.finalize()
        return {
            "plan_v": PLAN_SCHEMA,
            "algo": self.algo,
            "n": _scalar(self.n),
            "dtype": self.dtype,
            "ranks": _scalar(self.ranks),
            "regret": getattr(self, "total_regret", 0.0),
            "decisions": {k: d.to_dict()
                          for k, d in sorted(self.decisions.items())},
            "profile": _clean(self.profile),
        }

    def digest(self) -> dict[str, Any]:
        """Compact wire digest (the ``sortserve.v1`` response header's
        ``plan`` field): algo, negotiated cap, restage verdict, total
        regret — enough for a client to notice decision drift without
        shipping the whole record."""
        if not self.finalized:
            self.finalize()
        cap = self.decisions.get("cap")
        restage = self.decisions.get("restage")
        out: dict[str, Any] = {
            "algo": self.algo,
            "regret": getattr(self, "total_regret", 0.0),
        }
        if cap is not None:
            out["negotiated_cap"] = _scalar(cap.predicted.get("cap"))
            out["cap_regret"] = cap.regret
        if restage is not None:
            out["restaged"] = bool(restage.chosen)
        xeng = self.decisions.get("exchange_engine")
        if xeng is not None:
            out["exchange_engine"] = _scalar(xeng.chosen)
        batch = self.decisions.get("batch")
        if batch is not None:
            out["bucket"] = _scalar(batch.chosen)
        pl = self.decisions.get("planner")
        if pl is not None:
            # the planner's verdict rides the wire digest so clients
            # (and the serve_load plan fold) see policy drift directly
            out["planner"] = _scalar(pl.chosen)
            out["planner_regret"] = pl.regret
        ext = self.decisions.get("external")
        if ext is not None:
            # the typed evidence an over-budget request was
            # served by the spill tier, not rejected
            out["spilled"] = True
            out["spill_runs"] = _scalar(ext.actual.get("runs"))
            # a retried request that warm-resumed from a
            # journaled spill manifest says so in its reply digest
            if _scalar(ext.actual.get("resumed")):
                out["resumed"] = True
        # the doctor's plan-shaped verdicts (cap_thrash,
        # window_misfit) ride the digest so a mis-planned run
        # self-describes.  Lazy + best-effort: this module must stay
        # stdlib-only at import, and a
        # digest never fails because diagnosis did.
        try:
            from mpitest_tpu_torch.doctor import plan_findings
            df = plan_findings(self.to_attrs())
            if df:
                out["doctor"] = df
        except Exception:
            pass
        return out


def fold_decision_stats(plan_attrs: "list[dict]") -> dict[str, dict]:
    """Per-decision ``{count, regret_sum, regret_max}`` over a list of
    ``sort.plan`` span attr dicts — the ONE fold behind the ``/varz``
    decision snapshot and ``report.py --explain``'s aggregate table
    (two consumers of the same record must not re-implement and
    silently diverge)."""
    out: dict[str, dict] = {}
    for attrs in plan_attrs:
        decisions = (attrs or {}).get("decisions")
        if not isinstance(decisions, dict):
            continue
        for name, d in decisions.items():
            if not isinstance(d, dict):
                continue
            row = out.setdefault(name, {"count": 0, "regret_sum": 0.0,
                                        "regret_max": 0.0})
            row["count"] += 1
            try:
                r = float(d.get("regret", 0.0) or 0.0)
            except (TypeError, ValueError):
                r = 0.0
            row["regret_sum"] += r
            row["regret_max"] = max(row["regret_max"], r)
    return out


# ------------------------------------------------- input-distribution profile

#: Sample size of the host-side profile (the same ~1k strided sample
#: idiom as the skew sniffs — O(s log s), no key movement).
PROFILE_SAMPLE = 1024


def profile_host_array(x: Any, n_profile_sample: int = PROFILE_SAMPLE,
                       ) -> dict[str, float]:
    """Sortedness / run-length / duplicate-ratio estimates from an
    evenly-strided ~1k sample of the host keys — zero extra key
    movement (the values are about to be encoded anyway, and native
    value order IS the sort order for every supported dtype).
    Invariants (pinned in tests/test_plan.py): sorted input →
    sortedness == 1; constant input → dup_ratio == 1; reverse-sorted →
    sortedness ≈ 0.  NaN comparisons are False, so NaN-heavy float
    input reads as unsorted — conservative, never wrong-sided."""
    import numpy as np

    a = np.asarray(x).reshape(-1)
    n = int(a.size)
    if n == 0:
        return {}
    s = int(min(n_profile_sample, n))
    idx = np.linspace(0, n - 1, s).astype(np.int64)
    samp = a[idx]
    nondec = 1.0 if s < 2 else float(np.mean(samp[:-1] <= samp[1:]))
    descents = 0 if s < 2 else int(np.sum(~(samp[:-1] <= samp[1:])))
    # duplicate ratio over the sorted sample, normalized so a constant
    # input is exactly 1.0 and an all-distinct one exactly 0.0
    if s < 2:
        dup = 0.0
    else:
        ss = np.sort(samp)
        dup = float(np.sum(ss[:-1] == ss[1:])) / (s - 1)
    out = {
        "sortedness": round(nondec, 4),
        "run_len": round(s / (descents + 1), 2),
        "dup_ratio": round(dup, 4),
    }
    if np.issubdtype(samp.dtype, np.integer):
        # significant-bit width of the SAMPLED value range —
        # the radix_compact policy's trigger.  A strided sample can
        # miss the true extremes, so this may under-read: the planner's
        # predicted pass count is scored against the pass count the
        # full-range diff planner actually runs ("passes" regret = the
        # lying-profile cost).
        spread = int(samp.max()) - int(samp.min())
        out["key_width"] = int(spread).bit_length()
    return out


def profile_from_counts(cnts: Any, fair: int) -> dict[str, float]:
    """Skew factor and per-bin entropy from the ALREADY-MATERIALIZED
    [P, P] count-probe matrix (the negotiation probe — zero extra
    key movement).  ``bin_entropy`` is the normalized Shannon entropy of
    the destination mass (1.0 = perfectly balanced exchange, 0.0 = all
    keys to one peer); ``skew_factor`` is the max single-peer segment
    over the fair share — exactly the quantity that drives capacity."""
    import numpy as np

    c = np.asarray(cnts, dtype=np.float64)
    total = float(c.sum())
    out: dict[str, float] = {
        "skew_factor": round(float(c.max()) / max(int(fair), 1), 4),
    }
    if total > 0 and c.shape[-1] > 1:
        dest = c.sum(axis=0) / total
        nz = dest[dest > 0]
        ent = float(-(nz * np.log(nz)).sum()) / float(np.log(len(dest)))
        out["bin_entropy"] = round(ent, 4)
    return out


def enabled() -> bool:
    """``SORT_PLAN`` gate (on by default): plan provenance is minted,
    emitted as the ``sort.plan`` span and exported through the regret
    counters; ``off`` mints no plan record."""
    from mpitest_tpu_torch.utils import knobs

    return knobs.get("SORT_PLAN") != "off"
