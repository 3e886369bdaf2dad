"""The control of a cell's comparison: what `correct` would read if a
lower precision took the port's place. Not run by the benchmark's runs.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

For each seed, in one process: set-up and a short window at the cell's
own load, as `run.py` does; then, on the same requests,
- `logit_gap` and `miss_share` of the port (bf16) against the fp32
  reference, and of the control: the reference itself computed with
  every weight and matmul input in float8 e4m3, at each position the gap
  of the token it puts first (bf16's nearest lower precision);
- `search_gap` of the port's INT8 search, and of the port's own INT4
  path (`RetrievalConfig(bits=4)` over the same corpus and queries)
  against the INT8 reference.
One JSON line a seed; the limits are set between the two readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def int4_search(setup, records, device) -> float:
    """The port's INT4 index over the corpus, searched with the window's
    queries, held against the INT8 reference."""
    import dataclasses

    from bench import check, harness
    from repro_torch.core.sharded_index import ShardedDircIndex
    from repro_torch.serving import HashEmbedder

    index = setup.cell.config["index"]
    cfg4 = dataclasses.replace(harness.retrieval_config(index), bits=4)
    idx = ShardedDircIndex.build(setup.embs, cfg4, n_shards=index["n_shards"], device=device)
    queries = [r.req.query for r in records]
    res = idx.search(HashEmbedder(dim=index["dim"]).embed(queries), k=records[0].req.k)
    return check.gap_of(setup, queries, res.indices.cpu().numpy(), res.scores.cpu().numpy(),
                        records[0].req.k)


def control_seed(cell, seed: int, seconds: float, device) -> dict:
    """One seed's readings: the port's numbers and the control's."""
    from bench import check, harness

    setup = harness.set_up(cell, seed, seconds, False, device)
    run = harness.drive(setup, seconds, False)
    harness.tear_down(setup, run.records)
    recs = check.sample(run.records, seed, int(cell.load["check_tokens"]))
    t = time.monotonic()
    lg = check.logit_gaps(setup, recs, device, control=True)
    sg, n_searched = check.search_gap(setup, run.records)
    p = lg["program"]
    out = {"seed": seed, "logit_gap": p["gap"], "miss_share": p["flips"] / max(p["tokens"], 1),
           "search_gap": sg, "searched": n_searched, "program": p}
    done = [r for r in run.records if r.retrieval is not None and r.retrieval.doc_ids is not None]
    c = lg["control"]
    out.update(logit_gap_fp8=c["gap"], miss_share_fp8=c["flips"] / max(c["tokens"], 1),
               control=c, search_gap_int4=int4_search(setup, done, device))
    out["seconds"] = time.monotonic() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    from bench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: the control runs on the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_seed(cell, seed, args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
