"""A deployment of controller processes: ``python -m agac_tpu_torch
controller`` replicas, one shard lease each, against the frozen test API
server the harness starts and one durable fake account.

The replicas build their AWS from ``AGAC_CLOUD=fake`` and ``AGAC_FAKE_*``
(``cloudprovider/aws/factory.py``): the program has no seam through which
the harness could put its own AWS behind a process.  So the harness reads
the account's state file read-only (``perfbench/world/read.py``), counts
no AWS call of its own, and shapes nothing: every call of a replica
sleeps the account's latency in the replica.  Everything the run writes
(the state file, the kubeconfig, the replicas' logs) goes to a directory
under ``TMPDIR``, removed at the end.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import types
import urllib.request

from perfbench import breakdown
from perfbench.world import population as pop, read
from perfbench.world.testserver import TestApiServer
from perfbench.worlds.inprocess import KINDS, apply_change

LEASES_DEADLINE_S = 90.0
EXIT_DEADLINE_S = 15.0


def load_port() -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"agac_tpu_torch.{name}")
    return types.SimpleNamespace(
        apis=mod("apis"), egb=mod("apis.endpointgroupbinding"), objects=mod("cluster.objects"),
        errors=mod("errors"),
    )


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as response:
        return response.read()


def cpu_seconds(pid: int) -> float:
    """User and system CPU seconds process ``pid`` has used so far."""
    fields = pathlib.Path(f"/proc/{pid}/stat").read_text().rpartition(")")[2].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class World:
    def __init__(self, config: dict, population: pop.Population, record: dict, changes: list[dict]):
        self.config = config
        self.port = load_port()
        logging.getLogger("agac").setLevel(logging.CRITICAL)
        self.workdir = pathlib.Path(tempfile.mkdtemp(prefix="perfbench-fleet-"))
        self.state_path = self.workdir / "aws-state.json"
        creates = sum(1 for c in changes if c["op"] == "create")
        self.server = TestApiServer().start()
        self.cluster = self.server.cluster
        self.reader = read.StateFileReader(str(self.state_path), self.cluster)
        self.children: list[subprocess.Popen] = []
        self.ports: list[int] = []
        # replica index -> its last scrape and CPU seconds before a kill
        self.killed: dict[int, dict] = {}
        kubeconfig = self.workdir / "kubeconfig"
        kubeconfig.write_text(json.dumps({
            "current-context": "bench",
            "contexts": [{"name": "bench", "context": {"cluster": "bench", "user": "bench"}}],
            "clusters": [{"name": "bench", "cluster": {"server": self.server.url}}],
            "users": [{"name": "bench", "user": {}}],
        }))
        s = config["settings"]
        lb = population.shared_lb
        self.env = dict(
            os.environ,
            AGAC_CLOUD="fake",
            AGAC_FAKE_STATE=str(self.state_path),
            AGAC_FAKE_LBS=f"{lb}={pop.lb_host(lb)}",
            AGAC_FAKE_LATENCY=str(s["fake_latency_s"]),
            AGAC_FAKE_QUOTA_ACCELERATORS=str(len(record["services"]) + creates + 20),
            AGAC_API_HEALTH_AIMD_QPS=str(s["aimd_budget_qps"]),
            POD_NAMESPACE="kube-system",
            **{k: str(v) for k, v in config["lease"].items()},
            **{k: str(v) for k, v in s["env"].items()},
        )
        self.kubeconfig = kubeconfig

    def start(self) -> None:
        s = self.config["settings"]
        root = pathlib.Path(__file__).resolve().parent.parent.parent
        for replica in range(s["replicas"]):
            port = free_port()
            argv = [
                sys.executable, "-m", "agac_tpu_torch", "controller",
                "--kubeconfig", str(self.kubeconfig), "-c", self.config["cluster"],
                "-w", str(s["workers"]), "--queue-qps", str(s["queue_qps"]),
                "--queue-burst", str(s["queue_burst"]), "--health-port", str(port),
                "--shard-count", str(s["shard_count"]),
                "--shards-per-replica", str(s["shards_per_replica"]),
                *s.get("args", []),
            ]
            with open(self.workdir / f"replica-{replica}.out", "w") as out:
                self.children.append(subprocess.Popen(
                    argv, cwd=root, env=self.env, stdin=subprocess.DEVNULL,
                    stdout=out, stderr=subprocess.STDOUT,
                ))
            self.ports.append(port)
        end = time.monotonic() + LEASES_DEADLINE_S
        shards = set(range(s["shard_count"]))
        while time.monotonic() < end:
            self._alive()
            try:
                owned = [set(json.loads(get(f"http://127.0.0.1:{p}/healthz"))["sharding"].get("owned", ()))
                         for p in self.ports]
            except OSError:
                owned = []
            if owned and set().union(*owned) == shards and sum(map(len, owned)) == len(shards):
                return
            time.sleep(0.2)
        raise RuntimeError("the replicas did not take every shard lease")

    def holder(self, shard: int) -> int:
        """The index of the live replica that holds ``shard``."""
        for replica, port in enumerate(self.ports):
            if replica not in self.killed:
                owned = json.loads(get(f"http://127.0.0.1:{port}/healthz"))["sharding"].get("owned", ())
                if shard in owned:
                    return replica
        raise RuntimeError(f"no live replica holds shard {shard}")

    def kill(self, replica: int) -> None:
        """SIGKILL replica ``replica``; its counters and CPU as last read
        stand for it from then on."""
        child = self.children[replica]
        self.killed[replica] = {
            "exposition": get(f"http://127.0.0.1:{self.ports[replica]}/metrics").decode(),
            "cpu_s": cpu_seconds(child.pid),
        }
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=EXIT_DEADLINE_S)

    def _alive(self) -> None:
        for replica, child in enumerate(self.children):
            if replica not in self.killed and child.poll() is not None:
                log = (self.workdir / f"replica-{replica}.out").read_text(errors="replace")[-3000:]
                raise RuntimeError(f"replica {replica} exited with {child.returncode}: {log}")

    def close(self) -> None:
        for child in self.children:
            if child.poll() is None:
                child.send_signal(signal.SIGTERM)
        for child in self.children:
            try:
                child.wait(timeout=EXIT_DEADLINE_S)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(timeout=EXIT_DEADLINE_S)
        self.server.stop()
        shutil.rmtree(self.workdir, ignore_errors=True)

    # -- the benchmark's side -------------------------------------------
    def create_base(self, record: dict) -> None:
        for section in ("services", "ingresses", "bindings"):
            for entry in record[section].values():
                self.cluster.create(KINDS[section], self._object(section, entry))

    def _object(self, section: str, entry: dict):
        if section != "services":
            raise ValueError(f"a fleet deployment holds Services only, not {section}")
        return pop.service_object(self.port, entry)

    def apply(self, change: dict) -> None:
        apply_change(self.cluster, self.port, change, self._object)

    def arm(self, on: bool = True) -> None:
        """The account's latency is the replicas' own: always on."""

    def settle(self) -> None:
        self._alive()
        time.sleep(1.0)

    def idle_gaps(self, start: dict, end: dict) -> list:
        return breakdown.idle_gaps(start, end)

    def sources(self) -> dict:
        self._alive()
        live = [r for r in range(len(self.children)) if r not in self.killed]
        return {
            "aws_calls": None,
            "expositions": [get(f"http://127.0.0.1:{self.ports[r]}/metrics").decode() for r in live]
            + [k["exposition"] for k in self.killed.values()],
            "cpu_s": {self.children[r].pid: cpu_seconds(self.children[r].pid) for r in live}
            | {self.children[r].pid: k["cpu_s"] for r, k in self.killed.items()},
        }
