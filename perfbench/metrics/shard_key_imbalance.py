"""shard_key_imbalance: the most keys one replica's shards own over the
mean across replicas (``agac_shard_keys_owned``) at the end of the
measured span."""

from perfbench.exposition import total


def read(run):
    owned = [total([text], "agac_shard_keys_owned") for text in run.end["expositions"]]
    owned = [v for v in owned if v is not None]
    if len(owned) < 2 or not sum(owned):
        return None
    return max(owned) / (sum(owned) / len(owned))
