"""Mean host time of one ``Gateway.append``, in ms: the process's
``gateway.append_ns`` counter over its ``gateway.appends`` (the program's
``gateway.append`` spans, summed in the lane's registry), over every label.
Both are process totals: ``bench/run.py`` runs one cell per process, and
the first refresh of set-up is counted with the window's.  A refresh is
two appends.  None where the counters are absent or read no append."""


def read(run):
    from repro_torch.obs import default_registry
    counters = default_registry().snapshot()["counters"]

    def total(name):
        return sum(v for k, v in counters.items() if k.split("{")[0] == name)

    appends = total("gateway.appends")
    return total("gateway.append_ns") / appends / 1e6 if appends else None
