"""The closed-loop client pattern: each client sends a request, waits for
its answer, and sends the next.  A mix whose ``kind`` is ``closed_loop``
gives:

* ``clients``: how many;
* ``queries``: the queries they send, each ``agg``, ``expr`` and ``budget``
  (the arguments of the program's ``QueryBudget``; ``{}`` is exact);
* ``query_of``: ``"client"`` (client ``c`` always sends query ``c`` modulo
  their number) or ``"request"`` (each request draws its query from the
  run's seed);
* ``warm_widths``: set-up serves, for each query, one step of each of these
  widths (requests of their own, not checked), so that every stage the
  window runs is built before it;
* ``warm_rounds``: set-up rounds of the clients' own requests, one each, all
  answered (their sigmas feed the window's first requests);
* ``verify_sample`` and ``verify_span``: how many of the first
  ``verify_span`` answers of the window, drawn from the seed, are also held
  to the reference's strata arrays and draws.

Client ``c`` sends query id ``client<c>`` on dataset ``c`` modulo the
configuration's datasets; its ``k``-th request's sampling seed, and query
where drawn, come from the run's seed.  All requests of a run share one
filter seed, so each dataset's filter words are built once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.generators import sub_seed
from portbench.reference import join as ref_join

# how long after the close the queued requests may take to be answered
DRAIN_S = 60.0


def filter_seed(seed: int) -> int:
    """The datasets' filter-hash seed: one for every request of a run."""
    return sub_seed(seed, "filter") & 0xFFFFFFFF


def request(cell, seed: int, c: int, k: int) -> dict:
    """Client ``c``'s ``k``-th request: ``query_id``, ``dataset``, the index
    of its ``query`` in the mix's queries, and its sampling ``seed``."""
    tr = cell.traffic
    n_q = len(tr["queries"])
    q = c % n_q if tr["query_of"] == "client" \
        else sub_seed(seed, "query", c, k) % n_q
    return {"query_id": f"client{c}", "dataset": c % cell.datasets,
            "query": q,
            "seed": sub_seed(seed, "request", c, k) & 0x7FFFFFFF}


def planned(cell, seed: int, n: int) -> tuple[list, int]:
    """The requests a run sends when its window takes ``n`` of them, in an
    order that keeps each client's own: (the list, where the window's
    start)."""
    clients, k0 = int(cell.traffic["clients"]), int(cell.traffic["warm_rounds"])
    sent = [request(cell, seed, c, k) for k in range(k0)
            for c in range(clients)]
    first = len(sent)
    sent += [request(cell, seed, i % clients, k0 + i // clients)
             for i in range(n)]
    return sent, first


def verify_indices(seed: int, traffic: dict) -> set:
    """Which answers (in the order they come) are held to the reference's
    strata: ``verify_sample`` of the first ``verify_span``, drawn from the
    seed."""
    rng = np.random.default_rng(sub_seed(seed, "verify"))
    span = int(traffic["verify_span"])
    return {int(i) for i in rng.choice(
        span, min(int(traffic["verify_sample"]), span), replace=False)}


def _answer_row(res) -> torch.Tensor:
    d = res.diagnostics
    return torch.cat([torch.stack([res.estimate.double(),
                                   res.error_bound.double()]),
                      d.live_counts.double().reshape(-1),
                      torch.stack([torch.as_tensor(d.strata_overflow).double(),
                                   torch.as_tensor(d.num_strata).double()])])


def _detail(res) -> dict:
    """Copies, on the device, of a verified request's strata (and draws): a
    copy to the host inside the window would hold the step up."""
    st = res.strata
    d = {"keys": st.keys, "valid": st.valid, "counts": st.counts}
    if res.stats is not None:
        d.update(starts=st.starts, population=res.stats.population,
                 n_sampled=res.stats.n_sampled)
    return {k: v.clone() for k, v in d.items()}


class Clients:
    """The program's ``JoinServer`` with the configuration's datasets
    registered, and the mix's clients in front of it."""

    def __init__(self, ctx):
        from repro_torch.core.budget import QueryBudget
        from repro_torch.core.relation import relation
        from repro_torch.runtime.join_serve import JoinRequest, JoinServer

        cell, q = ctx.cell, ctx.cell.config["query"]
        self.cell, self.seed, tr = cell, ctx.seed, cell.traffic
        self.server = JoinServer(batch_slots=q["batch_slots"],
                                 tracer=ctx.tracer)
        self.caps = []
        for i in range(cell.datasets):
            rels = [relation(k, v, device=ctx.device)
                    for k, v in ctx.inputs(i)]
            self.server.register_dataset(f"d{i}", rels)
            self.caps.append([r.capacity for r in rels])
            del rels
        self.num_blocks = ref_join.num_blocks_for(
            max(max(c) for c in self.caps), q["fp_rate"])
        self.max_strata = q["max_strata"]
        fseed = filter_seed(ctx.seed)

        def make(r: dict):
            qq = tr["queries"][r["query"]]
            return JoinRequest(
                dataset=f"d{r['dataset']}",
                budget=QueryBudget(**qq["budget"]), agg=qq["agg"],
                expr=qq["expr"], fp_rate=q["fp_rate"],
                max_strata=q["max_strata"], b_max=q["b_max"],
                use_kernels=True, query_id=r["query_id"], seed=r["seed"],
                filter_seed=fseed)
        self.make = make
        self.clients = int(tr["clients"])
        self.made = [0] * self.clients
        self.pending: dict = {}
        self.sent: list = []        # every request of the clients, in order
        self.answers: list = []     # every answer of the window's requests
        self.requests: list = []    # timing of those answered in the window
        self.steps: list = []
        self.client_spans: list = []
        self.attempted = 0
        self.verify_at = verify_indices(ctx.seed, tr)
        self.counting = False       # window requests are being sent
        self.recording = False      # answers are kept for the check

    def submit(self, c: int) -> None:
        r = request(self.cell, self.seed, c, self.made[c])
        self.made[c] += 1
        req = self.make(r)
        t = time.perf_counter()
        self.server.submit(req)
        self.pending[c] = (req, t, len(self.sent))
        self.sent.append(r)
        self.attempted += self.counting

    def step(self, profile=None) -> tuple:
        """One server step; returns (clients answered, when the last answer
        reached the host)."""
        self.server.step()
        done = [c for c, (r, _, _) in self.pending.items() if r.done]
        if not done:
            raise RuntimeError("a server step answered no pending request")
        rows = torch.stack([_answer_row(self.pending[c][0].result)
                            for c in done]).cpu().numpy()
        t_ans = time.perf_counter()
        draws = []
        caps = self.caps[self.sent[self.pending[done[0]][2]]["dataset"]]
        for c, row in zip(done, rows):
            req, t_sub, i = self.pending.pop(c)
            res = req.result
            if not self.recording:
                continue            # a warm round: its sigmas are the point
            n_in = len(caps)
            a = {"i": i, "estimate": float(row[0]), "bound": float(row[1]),
                 "live": [int(x) for x in row[2:2 + n_in]],
                 "overflow": int(row[2 + n_in]),
                 "num_strata": int(row[3 + n_in]),
                 "sampled": bool(res.diagnostics.sampled)}
            if self.counting:
                self.requests.append({"queue_s": req.queue_latency_s,
                                      "e2e_s": t_ans - t_sub})
            if len(self.answers) in self.verify_at:
                a["detail"] = _detail(res)    # device copies until close
            if profile is not None and res.stats is not None:
                draws.append((res.stats.n_sampled, res.strata.counts,
                              res.stats.valid))
            self.answers.append(a)
        if profile is not None:
            width = ref_join.pow2_at_least(len(done))
            # pad slots repeat the last request's operands
            draws += draws[-1:] * (width - len(done))
            profile.step_info.append({
                "width": width,
                "caps": caps,
                "num_blocks": self.num_blocks, "max_strata": self.max_strata,
                "draws": draws or None})
        return done, t_ans

    def warm(self) -> None:
        """Set-up: the mix's warm widths of each query, then its warm
        rounds of the clients' own requests."""
        tr = self.cell.traffic
        for qi in range(len(tr["queries"])):
            for w in tr.get("warm_widths", []):
                reqs = [self.make({"query_id": f"warm.{qi}.{w}.{j}",
                                   "dataset": j % self.cell.datasets,
                                   "query": qi,
                                   "seed": sub_seed(self.seed, "warm", qi, w,
                                                    j) & 0x7FFFFFFF})
                        for j in range(w)]
                for r in reqs:
                    self.server.submit(r)
                while not all(r.done for r in reqs):
                    self.server.step()
        for _ in range(int(tr["warm_rounds"])):
            for c in range(self.clients):
                self.submit(c)
            while self.pending:
                self.step()

    def window(self, seconds: float, profile) -> float:
        """The measured window; returns its length in seconds.  A profile
        covers about its last ``profile.steps`` steps (none of the first
        ``profile.after``) and stops after the close, so that stopping it
        costs the window nothing."""
        self.counting = self.recording = True
        t0 = time.perf_counter()
        close = t0 + seconds
        for c in range(self.clients):
            self.submit(c)
        t_prev = time.perf_counter()
        while (now := time.perf_counter()) < close:
            n = len(self.steps)
            if profile is not None and profile.prof is None \
                    and n >= profile.after \
                    and close - now < profile.steps * (now - t0) / max(n, 1):
                profile.begin()
            ts = time.perf_counter()
            self.client_spans.append((t_prev, ts))
            done, t_ans = self.step(profile if profile is not None
                                    and profile.active else None)
            self.steps.append({"served": len(done), "t0": ts, "t1": t_ans})
            if time.perf_counter() < close:
                for c in done:
                    self.submit(c)
            t_prev = t_ans
        t_end = time.perf_counter()
        self.counting = False
        if profile is not None and profile.active:
            profile.end()
        return t_end - t0

    def drain(self) -> None:
        """Serve what the window left queued, for the check only."""
        end = time.perf_counter() + DRAIN_S
        while self.pending and time.perf_counter() < end:
            self.step()
