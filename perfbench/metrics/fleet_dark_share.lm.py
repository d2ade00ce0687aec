"""The share of the traced rounds' worker-rounds in which a worker is dark
through a fault, in %, from the fleet's instants on its
``fleet/worker <gid>`` tracks (``fleet/sim.py``'s ``drop`` and
``lag_start``, recorded on every round of a traced run): a drop darkens
its round, a packet parked at round r with lag L the rounds r to r + L,
each counted within the traced rounds. None without the instants."""


def read(run):
    events = run.work.get("fleet_events")
    if events is None:
        return None
    lo, hi = run.work["traced_rounds"]
    dark = 0
    for ev in events:
        if ev.get("ph") != "i" or ev.get("cat") != "fleet":
            continue
        r = ev["args"]["round"]
        if ev["name"] == "drop":
            last = r
        elif ev["name"] == "lag_start":
            last = r + ev["args"]["lag"]
        else:
            continue
        dark += max(0, min(last, hi - 1) - max(r, lo) + 1)
    return 100.0 * dark / (run.work["workers"] * (hi - lo))
