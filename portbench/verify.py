"""The comparison that decides ``correct``.

Every answered request is held to the reference on what it reports for the
whole query (live rows of each input, strata overflow, joinable strata) and
on its answer, by its own query: an exact one against the exact aggregate, a
sampled one against the estimate and bound that the reference computes from
the same draws, their number sized by the reference's own chain of sigmas
(:func:`portbench.reference.join.replay`).  A sample of them, drawn from the
run's seed, is also held to the reference's strata arrays and, when sampled,
to its number of draws of every stratum.  Each number is compared with its
limit from the cell's ``workloads/<cell>.json``; a NaN fails.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference import join as ref_join


def _gap(x: float, ref: float) -> float:
    if not (math.isfinite(x) and math.isfinite(ref)):
        return math.inf
    return abs(x - ref) / max(abs(ref), 1e-300)


def _strata_mismatch(d: dict, ref: dict) -> int:
    """Strata slots where the program's arrays differ from the reference's
    (starts over the valid slots only)."""
    bad = int((d["keys"] != ref["keys"]).sum())
    bad += int((d["valid"] != ref["valid"]).sum())
    bad += int((d["counts"] != ref["counts"]).sum())
    if "starts" in d:
        bad += int((d["starts"] != ref["starts"])[:, ref["valid"]].sum())
    if "population" in d:
        bad += int((d["population"].astype(np.float64)
                    != ref["population"]).sum())
    return bad


def _arrays(prep: ref_join.Prepared) -> dict:
    return {"keys": prep.keys.cpu().numpy(), "valid": prep.valid.cpu().numpy(),
            "starts": prep.starts.cpu().numpy(),
            "counts": prep.counts.cpu().numpy(),
            "population": prep.population.double().cpu().numpy()}


def kinds(queries: list) -> set:
    """``"sampled"`` and/or ``"exact"``: the answers a mix's queries get."""
    return {"sampled" if q.get("budget") else "exact" for q in queries}


def numbers(preps: list, queries: list, sent: list, answers: list,
            attempted: int, *, b_max: int) -> dict:
    """The compared numbers of one run.

    ``preps``: the reference's :class:`~portbench.reference.join.Prepared`
    of each dataset; ``queries``: the mix's queries; ``sent``: every request
    the clients sent, in order (``query_id``, ``dataset``, ``query``,
    ``seed``); ``answers``: one dict an answered request of the window
    (``i``, its index in ``sent``; ``estimate``, ``bound``, ``live``,
    ``overflow``, ``num_strata``, ``sampled`` and, for the verified sample,
    ``detail``: numpy arrays of its strata and draws).
    """
    ref = ref_join.replay(preps, queries, sent, b_max=b_max)
    arrays = [_arrays(p) for p in preps]
    out = {"unanswered": attempted - len(answers), "live_diff": 0,
           "overflow": 0, "path_diff": 0, "strata_diff": 0}
    has = kinds(queries)
    if "sampled" in has:
        out.update(draws_gap=math.nan, est_gap=0.0, bound_gap=0.0)
    if "exact" in has:
        out["exact_gap"] = 0.0
    for a in answers:
        r = sent[a["i"]]
        prep, want = preps[r["dataset"]], ref[a["i"]]
        sampled = isinstance(want, ref_join.Sampled)
        out["live_diff"] = max(out["live_diff"], int(sum(
            abs(int(x) - y) for x, y in zip(a["live"], prep.live))))
        out["overflow"] = max(out["overflow"], int(a["overflow"]))
        out["path_diff"] += int(bool(a["sampled"]) != sampled)
        out["strata_diff"] = max(out["strata_diff"],
                                 abs(int(a["num_strata"]) - prep.num_strata))
        d = a.get("detail")
        if d is not None:
            out["strata_diff"] = max(out["strata_diff"], _strata_mismatch(
                d, arrays[r["dataset"]]))
        if not sampled:
            out["exact_gap"] = max(out["exact_gap"], _gap(a["estimate"], want))
            continue
        out["est_gap"] = max(out["est_gap"], _gap(a["estimate"],
                                                  want.estimate))
        out["bound_gap"] = max(out["bound_gap"], _gap(a["bound"], want.bound))
        if d is not None:
            n = want.n.cpu().numpy()
            prog = d["n_sampled"].astype(np.int64) if "n_sampled" in d \
                else np.zeros_like(n)
            gap = int(np.abs(prog - n).max())
            out["draws_gap"] = gap if math.isnan(out["draws_gap"]) \
                else max(out["draws_gap"], gap)
    return out


def widest_truth_gap(preps: list, sent: list, answers: list) -> float:
    """The widest gap of a sampled answer to the true SUM, in its bounds
    (reported, not compared: a lower precision stays inside the bound)."""
    return max((abs(a["estimate"] - preps[sent[a["i"]]["dataset"]].truth)
                / a["bound"] if a["bound"] > 0 else math.inf
                for a in answers if a["sampled"]), default=math.nan)


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its limit;
    a number without a limit, or a NaN, fails."""
    checks, ok = {}, True
    for name, v in values.items():
        lim = limits.get(name)
        good = lim is not None and isinstance(v, (int, float)) \
            and not math.isnan(v) and v <= lim
        ok &= good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
