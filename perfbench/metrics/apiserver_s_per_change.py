"""apiserver_s_per_change: the wall seconds of the replicas' requests
to the API server, every verb and status, watches to their response
headers (``agac_apiserver_request_duration_seconds``), summed over the
replicas, over the measured span, per change."""

from perfbench.walltime import seconds_per_change


def read(run):
    return seconds_per_change(run, "agac_apiserver_request_duration_seconds")
