"""FCT query launcher: generate a star database and answer an FCT query
through the session service API.

    python -m repro_torch.launch.fct_run --keywords alps bordeaux --top-k 8 \
        --mode skew --rho 4 --scale 2 --repeat 3 [--device cpu] [--workers 8] \
        [--trace-out trace.json]

Runs on the CUDA device by default (``--device cpu`` to run on the CPU).
``--repeat`` re-runs the query to show the warm latency next to the cold one;
the cold/warm label comes from the engine's program-build delta of that rep.
``--trace-out`` writes every rep's span tree as Chrome trace-event JSON
(chrome://tracing or Perfetto).  On the card each rep also prints the
device time of routing, MR¹ and MR² (``timings['device_*_ms']``).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--keywords", nargs="+", default=["alps", "bordeaux"])
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--r-max", type=int, default=4)
    ap.add_argument("--mode", default="uniform",
                    choices=["uniform", "skew", "round_robin"])
    ap.add_argument("--rho", type=int, default=4)
    ap.add_argument("--sample-frac", type=float, default=0.25)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the query N times (warm runs hit the program "
                         "cache and the device-resident store)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--workers", type=int, default=1,
                    help="P, virtual MapReduce workers on the device")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write every rep's span tree as Chrome trace-event "
                         "JSON (chrome://tracing / Perfetto)")
    args = ap.parse_args(argv)

    from repro_torch.api import FCTRequest, FCTSession
    from repro_torch.data.demo import TOK, build_db
    from repro_torch.obs import write_chrome_trace

    schema = build_db(n_fact=int(2000 * args.scale))
    session = FCTSession(schema, device=args.device, n_workers=args.workers,
                         tokenizer=TOK)
    req = FCTRequest(keywords=tuple(args.keywords), top_k=args.top_k,
                     r_max=args.r_max, mode=args.mode, rho=args.rho,
                     sample_frac=args.sample_frac)
    res, traces = None, []
    for rep in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        res = session.query(req)
        ms = (time.perf_counter() - t0) * 1e3
        traces.append(res.trace)
        label = "cold" if res.cold else "warm"
        t = res.timings
        print(f"run {rep} ({label}): {ms:.1f}ms "
              f"(plan {t['plan_ms']:.1f} dispatch {t['dispatch_ms']:.1f} "
              f"collect {t['collect_ms']:.1f} "
              f"finalize {t['finalize_ms']:.1f}) "
              f"builds={res.engine_stats['traces']} "
              f"uploads={res.engine_stats['store_uploads']}")
        if "device_route_ms" in t:
            print(f"  device: route {t['device_route_ms']:.2f} "
                  f"mr1 {t['device_mr1_ms']:.2f} "
                  f"mr2 {t['device_mr2_ms']:.2f} ms")
    print(f"device={session.device} workers={args.workers} "
          f"query={args.keywords} mode={args.mode} "
          f"CNs={res.n_cns} (joined {res.n_joined_cns}) "
          f"shuffle={res.shuffle_bytes / 1e6:.2f}MB "
          f"imbalance={res.imbalance:.2f}")
    st = session.stats()
    print(f"engine: {st['entries']} cached programs, "
          f"{st['hits']} hits / {st['misses']} misses, "
          f"{st['traces']} builds, {st['evictions']} evictions, "
          f"{st['batches_run']} batched dispatches for {st['cns_run']} CNs; "
          f"plan cache {st['plan_hits']} hits")
    for word, freq in res.topk():
        print(f"  {word:16s} {freq}")
    if args.trace_out:
        n_events = write_chrome_trace(args.trace_out, traces)
        print(f"trace -> {args.trace_out} ({len(traces)} reps, "
              f"{n_events} events)")


if __name__ == "__main__":
    main()
