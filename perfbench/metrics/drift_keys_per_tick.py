"""drift_keys_per_tick: the keys one round of the drift tickers enqueues:
for each controller, the keys its ticks enqueued over the measured span
(``agac_drift_tick_keys_total``) over its ticks that ran
(``agac_drift_ticks_total{outcome="ran"}``), summed over the controllers
that ticked.  A Service or an Ingress is a key of both the Global
Accelerator and the Route53 controller."""

from perfbench.exposition import samples


def _by_controller(texts: list[str], name: str, where: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for text in texts:
        for sample, labels, value in samples(text):
            if sample == name and where in labels:
                controller = labels.split('controller="', 1)[1].split('"', 1)[0]
                out[controller] = out.get(controller, 0.0) + value
    return out


def _delta(run, name: str, where: str = "") -> dict[str, float]:
    start = _by_controller(run.start["expositions"], name, where)
    return {c: v - start.get(c, 0.0) for c, v in _by_controller(run.end["expositions"], name, where).items()}


def read(run):
    ran = _delta(run, "agac_drift_ticks_total", 'outcome="ran"')
    keys = _delta(run, "agac_drift_tick_keys_total")
    per_tick = [keys.get(controller, 0.0) / ticks for controller, ticks in ran.items() if ticks > 0]
    return sum(per_tick) if per_tick else None
