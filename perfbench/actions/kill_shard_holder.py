"""SIGKILL to the replica process that holds shard ``shard``, in a
deployment of processes; the survivors take its shards over when its
leases expire."""


def run(world, shard: int = 0) -> None:
    world.kill(world.holder(shard))
