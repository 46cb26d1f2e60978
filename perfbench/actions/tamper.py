"""An out-of-band change to AWS, made behind the controllers' back as an
operator in the console would: ``kind`` on ``target``, in a deployment
that supports it (``perfbench/worlds/inprocess_drift.py``).  The
objects the reference judges do not change, so the change counts as
repaired once the world reads as the reference expects again."""


def run(world, kind: str, target: str) -> None:
    world.tamper(kind, target)
