"""reconciles_per_change: sync passes of every result
(``agac_reconcile_results_total``) over the measured span, per change."""

from perfbench.exposition import delta


def read(run):
    passes = delta(run, "agac_reconcile_results_total")
    if passes is None or not run.changes:
        return None
    return passes / run.changes
