"""FCT serving loop: a multi-tenant Gateway answering streamed queries.

Reads keyword queries (one per line) from stdin or a file and streams them
through the serving gateway (``repro_torch.serve``): a SchemaRegistry of named
datasets, a per-tenant ~1ms dynamic-batching window (same-window queries
share stacked device dispatches) and a per-tenant TTL result cache (whole
repeated queries are answered with zero engine dispatches).  Responses
print as soon as their future resolves, with per-query latency and
cold / warm / cached status — the serving demo for the paper's online
query-refinement workload at multi-user traffic.

Two schemas are registered: ``demo`` (the small star database of
``repro_torch.data.demo``, the default tenant) and ``tpch`` (a TPC-H-like
dataset, generated lazily on first query).  Address a tenant with a
``schema:`` prefix:

    # interactive / piped — default schema
    echo "alps bordeaux" | PYTHONPATH=src python -m repro_torch.launch.fct_serve

    # multi-schema syntax, tuned gateway, 8 virtual workers
    printf 'demo: alps bordeaux\\ntpch: green sky\\n' | \\
        PYTHONPATH=src python -m repro_torch.launch.fct_serve --workers 8 \\
            --batch-window-ms 2 --result-cache-ttl 30 --max-inflight 16

    # self-checking multi-schema smoke run
    PYTHONPATH=src python -m repro_torch.launch.fct_serve --smoke

Every tenant runs on ``--device`` (default ``cuda``; the launcher refuses
to start without a card unless ``--device cpu`` is given) with ``--workers``
virtual MapReduce workers.

Observability (``repro_torch.obs``): ``--metrics-out`` streams periodic
JSON-lines snapshots of the process metrics registry (per-tenant latency
histograms, cache hit counters, shuffle bytes),
``--trace-out`` writes the served queries' span trees as a Chrome
trace-event file (load in chrome://tracing or Perfetto), and the stdin
lines ``stats`` / ``metrics`` print the gateway stats dict / a registry
snapshot instead of being parsed as queries.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

DEFAULT_SCHEMA = "demo"

# (schema, query) pairs: repeats within and across bursts exercise the
# result cache; both tenants in one stream exercise multi-schema serving
SMOKE_QUERIES = [
    "demo: alps bordeaux",          # compiles this shape family
    "demo: alps bordeaux",          # repeat: result cache (after 1st burst)
    "demo: polished azure",         # same shapes, different keywords
    "demo: alps express priority",  # 3-keyword query: new CN family
    "tpch: green sky",              # second tenant (lazily generated)
    "tpch: blue river stone",
    "demo: bordeaux fragile",
    "tpch: green sky",
]


def parse_line(line: str, default_schema: str, known=None):
    """``[schema:] kw1 kw2 ...`` -> (schema, [keywords]).

    Only a REGISTERED tenant name (when ``known`` is given) is treated as a
    prefix, so a plain keyword that happens to contain a colon still routes
    to the default schema instead of being rejected as an unknown tenant.
    """
    schema, sep, rest = line.partition(":")
    schema = schema.strip()
    if sep and " " not in schema and (known is None or schema in known):
        return schema, rest.split()
    return default_schema, line.split()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", default=None, metavar="PATH",
                    help="read queries from a file instead of stdin")
    ap.add_argument("--smoke", action="store_true",
                    help="run a canned multi-schema stream and self-check "
                         ": batching, result caching, tenant isolation")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--r-max", type=int, default=4)
    ap.add_argument("--mode", default="uniform",
                    choices=["uniform", "skew", "round_robin"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--cache-max-entries", type=int, default=None,
                    help="TOTAL executable-cache budget, partitioned across "
                         "tenants (each gets its own LRU-capped engine)")
    ap.add_argument("--batch-window-ms", type=float, default=1.0,
                    help="dynamic-batching window per tenant (0 = flush "
                         "as fast as possible)")
    ap.add_argument("--result-cache-ttl", type=float, default=60.0,
                    metavar="S", help="result-cache TTL in seconds "
                    "(0 disables result caching)")
    ap.add_argument("--max-inflight", type=int, default=32,
                    help="gateway backpressure: max uncached requests in "
                         "flight before submit() blocks")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write served queries' span trees as Chrome "
                         "trace-event JSON (first %d traced requests)"
                         % 1024)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="stream periodic JSON-lines metrics snapshots "
                         "(one line per interval + one final line)")
    ap.add_argument("--metrics-interval", type=float, default=10.0,
                    metavar="S", help="seconds between --metrics-out lines")
    ap.add_argument("--device", default="cuda",
                    help="torch device every tenant runs on (default cuda)")
    ap.add_argument("--workers", type=int, default=1,
                    help="P, virtual MapReduce workers on the device")
    args = ap.parse_args(argv)

    from repro_torch.api import FCTRequest
    from repro_torch.data.demo import TOK, build_db
    from repro_torch.data.tpch import TpchConfig
    from repro_torch.launch.mesh import resolve_device
    from repro_torch.obs import JsonLinesReporter, write_chrome_trace
    from repro_torch.serve import Gateway, GatewayConfig, SchemaRegistry

    # refuse before any data is built: no card, no serving, unless the
    # caller asked for the CPU
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    # the smoke run asserts tenant isolation, which needs per-tenant engines
    # — give it a real (partitioned) executable budget unless one was set
    cache_total = args.cache_max_entries
    if args.smoke and cache_total is None:
        cache_total = 64
    registry = SchemaRegistry(total_cache_entries=cache_total, device=device,
                              n_workers=args.workers)
    registry.register("demo", build_db(n_fact=int(2000 * args.scale)),
                      tokenizer=TOK)
    registry.register("tpch", TpchConfig(scale=0.25 * args.scale),
                      tokenizer=TOK)
    # the smoke run asserts on window occupancy and on second-stream cache
    # hits: widen the 1ms window default so a descheduled runner cannot
    # split the canned burst, and floor the TTL so first-stream compile time
    # cannot expire the entries the self-check relies on
    window_ms = max(args.batch_window_ms, 5.0) if args.smoke \
        else args.batch_window_ms
    result_ttl = max(args.result_cache_ttl, 3600.0) if args.smoke \
        else args.result_cache_ttl
    gateway = Gateway(registry, GatewayConfig(
        batch_window_ms=window_ms,
        result_cache_ttl_s=result_ttl,
        max_inflight=args.max_inflight))
    print(f"# gateway up in {(time.perf_counter() - t0) * 1e3:.0f}ms — "
          f"tenants {registry.names()} (default {DEFAULT_SCHEMA!r}) on "
          f"{device} x {args.workers} workers, "
          f"window {window_ms}ms, result TTL {result_ttl}s, "
          f"max in-flight {args.max_inflight}", flush=True)

    reporter = (JsonLinesReporter(gateway.metrics, args.metrics_out,
                                  interval_s=args.metrics_interval)
                if args.metrics_out else None)
    kept_traces = []                    # first N served traces, for export

    def make_request(words):
        return FCTRequest(keywords=tuple(words), top_k=args.top_k,
                          r_max=args.r_max, mode=args.mode)

    def report(idx, schema, line, resp, wall_ms):
        state = ("cached" if resp.cache_hit
                 else "cold" if resp.cold else "warm")
        terms = " ".join(f"{w}({c})" for w, c in resp.topk())
        print(f"[{idx}] {schema}: {line!r}: {wall_ms:.1f}ms ({state}) "
              f"cns={resp.n_joined_cns} -> {terms}", flush=True)

    def serve(lines, collect=False):
        """Submit queries as they arrive; print responses as their futures
        resolve (FIFO per submission order).  The gateway enforces the
        in-flight bound — a burst past --max-inflight blocks here until a
        window flushes.  Returns the responses when ``collect`` (smoke only
        — they hold full frequency vectors, so an open-ended stream must
        not retain them)."""
        n = 0
        inflight = []  # [(idx, schema, line, future, t_submit)]
        out = [] if collect else None

        def pop_oldest():
            idx, schema, line, fut, t1 = inflight.pop(0)
            try:
                resp = fut.result()
            except Exception as e:
                print(f"[{idx}] {schema}: {line!r}: failed ({e})", flush=True)
                return
            report(idx, schema, line, resp, (time.perf_counter() - t1) * 1e3)
            if resp.trace is not None and len(kept_traces) < 1024:
                kept_traces.append(resp.trace)
            if out is not None:
                out.append(resp)

        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line == "stats":          # introspection command, not a query
                print(json.dumps(gateway.stats(), indent=2, sort_keys=True,
                                 default=str), flush=True)
                continue
            if line == "metrics":
                print(json.dumps(gateway.metrics.snapshot(), indent=2,
                                 sort_keys=True, default=str), flush=True)
                continue
            schema, words = parse_line(line, DEFAULT_SCHEMA,
                                       registry.names())
            try:
                fut = gateway.submit(schema, make_request(words))
            except (ValueError, KeyError) as e:
                print(f"[{n}] {line!r}: rejected ({e})", flush=True)
                n += 1
                continue
            inflight.append((n, schema, " ".join(words), fut,
                             time.perf_counter()))
            while inflight and inflight[0][3].done():  # stream results
                pop_oldest()
            # bound the print queue too: cache hits bypass the gateway's
            # semaphore, so a fast cached stream behind one slow cold head
            # would otherwise retain unbounded full-histogram responses
            while len(inflight) >= args.max_inflight:
                pop_oldest()
            n += 1
        while inflight:
            pop_oldest()
        return out

    if args.smoke:
        first = serve(SMOKE_QUERIES, collect=True)
    elif args.queries:
        with open(args.queries) as f:
            serve(f)
    else:
        serve(sys.stdin)

    if args.smoke:
        import numpy as np
        # a second identical stream must be answered entirely from the
        # result caches: bit-identical histograms, zero engine dispatches
        sessions = {name: registry.session(name) for name in ("demo", "tpch")}
        before = {n: s.engine.batches_run for n, s in sessions.items()}
        second = serve(SMOKE_QUERIES, collect=True)
        assert len(first) == len(SMOKE_QUERIES) == len(second), \
            "lost responses"
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a.all_freqs, b.all_freqs)
        assert all(r.cache_hit for r in second), \
            "second stream missed the result cache"
        assert all(s.engine.batches_run == before[n]
                   for n, s in sessions.items()), \
            "result-cache hits dispatched device work"
        st = gateway.stats()
        # the burst was submitted faster than the window: the batcher must
        # have stacked several queries into one flush
        assert st["demo"]["max_window_queries"] >= 2, \
            f"no dynamic batching: {st['demo']}"
        # tenant isolation: private engines with partitioned budgets when a
        # total cache budget is given, distinct engines regardless
        assert sessions["demo"].engine is not sessions["tpch"].engine, \
            "tenants share an engine despite per-tenant budgets"
        # a different top_k must still hit (served from the full histogram)
        r = gateway.query("demo", FCTRequest(
            keywords=("alps", "bordeaux"), top_k=2, r_max=args.r_max,
            mode=args.mode))
        assert r.cache_hit and len(r.terms) == 2, "top_k slicing missed"
        # explicit invalidation forces re-execution
        assert gateway.invalidate("demo") > 0
        r = gateway.query("demo", make_request(["alps", "bordeaux"]))
        assert not r.cache_hit, "invalidated entry still served"

        # -- observability self-check -------------------------------------
        # per-tenant metrics snapshot: latency histogram with ordered
        # percentiles, result-cache hit rate, engine shuffle volume
        snap = gateway.metrics.snapshot()
        counters, hists = snap["counters"], snap["histograms"]
        for tenant in ("demo", "tpch"):
            lat = hists.get("gateway.query_latency_ms{schema=%s}" % tenant)
            assert lat and lat["count"] > 0, \
                f"no latency samples for {tenant}: {sorted(hists)}"
            assert lat["p50"] <= lat["p95"] <= lat["p99"], lat
            assert "engine.bytes_shipped{schema=%s}" % tenant in counters, \
                f"no engine instruments labeled for {tenant}"
        # the demo tenant's queries join CNs, so device dispatches shipped
        # send tables (tpch's canned keywords legitimately join nothing)
        assert counters["engine.bytes_shipped{schema=demo}"] > 0, \
            "no shuffle bytes attributed to demo"
        hits = counters["result_cache.hits{schema=demo}"]
        misses = counters["result_cache.misses{schema=demo}"]
        assert hits > 0 and hits / (hits + misses) > 0.2, \
            f"result-cache hit rate implausibly low: {hits}h/{misses}m"
        # span coverage: engine-executed responses carry the full stage
        # tree; cache hits record the gateway-edge lookup + re-slice
        for resp in first + second:
            names = set(resp.trace.span_names())
            if resp.cache_hit or resp.coalesced:
                assert {"cache.lookup", "finalize"} <= names, names
            else:
                assert {"plan", "dispatch", "collect", "finalize",
                        "cache.lookup", "batcher.window"} <= names, names
        # on CUDA a batch's first response also carries the device stage
        # times (engine.DEVICE_STAGES)
        from repro_torch.runtime.engine import DEVICE_STAGES
        assert all(set(r.timings) - set(DEVICE_STAGES) == {
            "plan_ms", "dispatch_ms", "collect_ms", "finalize_ms",
            "execute_ms", "total_ms"} for r in first + second), \
            "timings keys drifted"
        print("# obs self-check: per-tenant histograms, hit rates and span "
              "coverage OK", flush=True)

    st = gateway.stats()
    gateway.close()
    registry.close()
    if reporter is not None:
        reporter.close()                # writes one final snapshot line
        print(f"# metrics -> {args.metrics_out}", flush=True)
    if args.trace_out:
        n_events = write_chrome_trace(args.trace_out, kept_traces)
        print(f"# trace -> {args.trace_out} ({len(kept_traces)} requests, "
              f"{n_events} events)", flush=True)
    for name in registry.names():
        if name not in st:
            continue
        t = st[name]
        print(f"# {name}: {t['queries_served']} served | results "
              f"{t['result_hits']}h/{t['result_misses']}m | windows "
              f"{t['windows_flushed']} (mean {t['mean_window_queries']} "
              f"q/window, peak {t['max_window_queries']}) | programs "
              f"{t['entries']} ({t['hits']}h {t['traces']}t "
              f"{t['evictions']}e) | store {t['store_hits']}h/"
              f"{t['store_uploads']}u", flush=True)
    print(f"# gateway: {st['gateway']['submitted']} submitted across "
          f"{st['gateway']['tenants']} tenants", flush=True)
    if args.smoke:
        print("SMOKE OK")


if __name__ == "__main__":
    main()
