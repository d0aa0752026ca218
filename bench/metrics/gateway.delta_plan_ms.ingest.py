"""Mean host time one ``Gateway.append`` spends planning the delta, in ms:
the process's ``gateway.delta_plan_ns`` counter (the ``plan.cn_plan`` spans
inside its ``session.delta_freq`` spans, summed in the lane's registry) over
its ``gateway.appends``, over every label.  Both are process totals:
``bench/run.py`` runs one cell per process, and the first refresh of
set-up is counted with the window's.  None where the counters are absent
or read no append."""


def read(run):
    from repro_torch.obs import default_registry
    counters = default_registry().snapshot()["counters"]

    def total(name):
        return sum(v for k, v in counters.items() if k.split("{")[0] == name)

    appends = total("gateway.appends")
    return total("gateway.delta_plan_ns") / appends / 1e6 if appends else None
