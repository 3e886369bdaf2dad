"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (`bench/reference`), once the window has
closed and the port's state is freed.

The numbers that the cell's file gives a limit, of these:
- `search_gap`: for every request due in the window whose retrieval
  finished, the reference embeds the query, quantises it and the corpus,
  and scores every document; the number is the largest gap, over those
  requests and their k ranks, between a score the port returned and the
  reference's score at the same rank, or the reference's score of the
  document the port returned there (a missed or wrong document shows in
  one of the two).
- `logit_gap`: a sample, drawn from the seed, of the finished requests,
  the one with the longest answer first, until it holds `check_tokens`
  served tokens. The reference builds each prompt from its own top-k and
  runs the model once over the prompt and the served tokens; the number
  is the widest gap by which a served token's logit lies below the
  reference's best at its position. Tokens are greedy, so a served token
  is the port's own best; where the port departs from the model, the gap
  opens.
- `miss_share`: on the same sample, the share of served tokens that are
  not the reference's best. For a model whose top-k routing sends a
  token near a tie by its rounding (bf16 as fp32 do), the widest gap is
  that of one such token and no longer tells a precision from another;
  how often the served token misses still does.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import embed, traffic, weights
from bench.reference import lm, prompt, retrieval


def search_gap(setup, records: list) -> tuple[float, int]:
    """(the widest gap, requests compared) over `records` whose retrieval
    finished."""
    done = [r for r in records if r.retrieval is not None and r.retrieval.doc_ids is not None]
    if not done:
        return float("nan"), 0
    return gap_of(setup, [r.req.query for r in done], [r.retrieval.doc_ids for r in done],
                  [r.retrieval.doc_scores for r in done], done[0].req.k), len(done)


def gap_of(setup, queries: list, ids: list, scores: list, k: int) -> float:
    """The widest gap of returned (ids, scores) rows against the
    reference's search of `queries`."""
    index = setup.cell.config["index"]
    proj = embed.projection(index["dim"])
    q = np.stack([embed.embed_text(t, proj) for t in queries])
    dc = retrieval.quantize(setup.embs, index["bits"])
    ref = retrieval.cosine_scores(retrieval.quantize(q, index["bits"]), dc,
                                  retrieval.int_norms(dc))
    _, best = retrieval.top_k(ref, k)
    gap = 0.0
    for row in range(len(queries)):
        got_ids = np.asarray(ids[row], np.int64)
        got = np.asarray(scores[row], np.float64)
        if got_ids.shape != best[row].shape or (got_ids < 0).any():
            return float("inf")
        gap = max(gap, float(np.abs(got - best[row]).max()),
                  float(np.abs(got - ref[row, got_ids]).max()))
    return gap


def sample(records: list, seed: int, check_tokens: int) -> list:
    """The finished requests to hold against the model: the longest
    answer, then others in an order drawn from the seed, until
    `check_tokens` served tokens."""
    done = [r for r in records if r.ok and len(r.gen.tokens) > 0]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.gen.tokens), -r.req.index))
    rest = [r for r in done if r is not longest]
    order = traffic.rng(seed, 3).permutation(len(rest))
    out, n = [longest], len(longest.gen.tokens)
    for i in order:
        if n >= check_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].gen.tokens)
    return out


def reference_inputs(setup, recs: list) -> tuple[list, list, list]:
    """Each sampled request's reference prompt (from the reference's own
    top-k) with its served tokens: (sequences, positions to read, served)."""
    cfg, index = setup.cell.config, setup.cell.config["index"]
    proj = embed.projection(index["dim"])
    dc = retrieval.quantize(setup.embs, index["bits"])
    dn = retrieval.int_norms(dc)
    seqs, reads, served = [], [], []
    for r in recs:
        q = retrieval.quantize(embed.embed_text(r.req.query, proj)[None], index["bits"])
        ids, _ = retrieval.top_k(retrieval.cosine_scores(q, dc, dn), r.req.k)
        p = prompt.rag_prompt(r.req.query, [setup.texts[i] for i in ids[0]],
                              setup.max_prompt, cfg["vocab_size"])
        toks = [int(t) for t in r.gen.tokens]
        seqs.append(p + toks[:-1])
        reads.append(list(range(len(p) - 1, len(p) - 1 + len(toks))))
        served.append(toks)
    return seqs, reads, served


def _gap_stats(ref: list, chosen: list) -> dict:
    """The widest gap of the `chosen` tokens below the reference's best,
    with the reference's margins (best - second best) at those positions,
    the chosen tokens' distinct count and how many were not the best."""
    gap, n, flips, margins, distinct = 0.0, 0, 0, [], 0
    for logits, toks in zip(ref, chosen):
        t = torch.as_tensor(toks, device=logits.device)
        g = logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]
        gap = max(gap, float(g.max()))
        n += len(toks)
        flips += int((g > 0).sum())
        top2 = logits.topk(2, dim=-1).values
        margins += (top2[:, 0] - top2[:, 1]).tolist()
        distinct += len(set(toks))
    q = np.quantile(margins, [0.0, 0.1, 0.5]) if margins else [float("nan")] * 3
    return {"gap": gap, "tokens": n, "flips": flips, "distinct": distinct,
            "margin_min": float(q[0]), "margin_p10": float(q[1]), "margin_med": float(q[2])}


def logit_gaps(setup, recs: list, device: torch.device, control: bool = False) -> dict:
    """{"program": stats} of the served tokens and, with `control`, also
    {"control": stats} of the tokens the fp8 reference puts first at the
    same positions (the control in the port's place)."""
    cfg = setup.cell.config
    seqs, reads, served = reference_inputs(setup, recs)

    def make(group: int) -> dict:
        return weights.make(cfg, setup.seed, group, device)

    ref = lm.logits_at(cfg, make, seqs, reads, device)
    out = {"program": _gap_stats(ref, served)}
    if control:
        low = lm.logits_at(cfg, make, seqs, reads, device, precision="fp8")
        out["control"] = _gap_stats(ref, [lg.argmax(dim=-1).tolist() for lg in low])
    return out


def compare(setup, records: list, device: torch.device) -> dict:
    """{name: {"value", "limit"}} and the seconds the comparison took."""
    t = time.monotonic()
    limits = setup.cell.load["limits"]
    sg, n_searched = search_gap(setup, records)
    recs = sample(records, setup.seed, int(setup.cell.load["check_tokens"]))
    prog = logit_gaps(setup, recs, device)["program"] if recs else {
        "gap": float("inf"), "tokens": 0, "flips": 0}
    values = {"search_gap": sg, "logit_gap": prog["gap"],
              "miss_share": prog["flips"] / prog["tokens"] if prog["tokens"] else float("inf")}
    return {"checks": {k: {"value": values[k], "limit": v} for k, v in limits.items()},
            "searched": n_searched, "sampled": len(recs), "tokens": prog["tokens"],
            "seconds": time.monotonic() - t}


def correct(result: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in result["checks"].values())
