"""The port's static analyses against the reference's.

1. The whole-program analyses, built by the reference over
   ``agac_tpu/`` and by the port over ``agac_tpu_torch/``, give equal
   blocks (lock order, census, determinism, confinement) and equal
   findings once the package name is mapped and source positions
   (``path``, ``line``, a ``:<line>`` suffix) are dropped.  The port's
   docstrings are shorter, so its lines differ; the port's extra module,
   ``graft_entry.py``, holds no lock, no shared state and no thread, so
   it adds nothing to any block.  The functions the port adds to fix a
   fault the reference keeps (``PORT_ONLY_FUNCTIONS``) are taken out of
   the port's program first: what they reach (the sweeper's teardown
   workers reach the whole reconcile loop) is the port's deliberate
   difference, and the rest must be the reference's.
2. The rules and analyses scoped to the package root (``unseamed-clock``,
   ``cross-boundary-capture``, ``untapped-external-input``, the census's
   single-threaded modules, the thread-sanctioned modules) give the
   reference's answers under either root: a scope that missed the port's
   root would check nothing there, and its zero would be vacuous.
3. The port's linter over ``agac_tpu_torch/`` finds nothing, and its
   program gate with the port's baseline is clean.
4. The reference's confinement cases that pin a module name of
   ``agac_tpu`` (deselected from the alias suite), with the name mapped.
5. ``chip_smoke.py``'s ``analysis`` phase on a small fleet.

Both packages are imported inside fixtures: the repository's linter
treats only ``agac_tpu``, ``tests`` and ``bench`` as first party."""

from __future__ import annotations

import importlib
import json
import pathlib
import re
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
# functions of the port with no counterpart in the reference, named as
# the reference would name them (ROADMAP.md Queue 3): the drain fence of
# the live resize; the release of a replica's journeys of keys it stops
# serving, the quota slice of a drained dropped shard and the
# autoscaler's fleet-wide cooldowns; the sweeper's teardown workers,
# the disable's discovery refresh, the durable account's cursor pages,
# the adoption's single read-plane drop that keeps known tags, the
# per-shard report store; the renewal of a lease whose release waits on
# a reconcile, the durable account's shared settle counts, the watch
# that resumes after an idle read timeout, and the test apiserver's
# check for a watch client gone
PORT_ONLY_FUNCTIONS = frozenset({
    "agac_tpu.sharding.membership::ShardFilter.inflight",
    "agac_tpu.sharding.membership::ShardMembership._adopting",
    "agac_tpu.sharding.membership::ShardMembership._flush_releases",
    "agac_tpu.sharding.membership::ShardMembership._released",
    "agac_tpu.sharding.membership::ShardMembership._dropped_drained",
    "agac_tpu.observability.journey::JourneyTracker.release",
    "agac_tpu.autoscaler.policy::ScalePolicy._observe_epoch",
    "agac_tpu.autoscaler.policy::ScalePolicy.note_executed",
    "agac_tpu.controllers.garbagecollector::OrphanTeardown.__init__",
    "agac_tpu.controllers.garbagecollector::OrphanTeardown.tearing_down",
    "agac_tpu.controllers.garbagecollector::OrphanTeardown.hand_over",
    "agac_tpu.controllers.garbagecollector::OrphanTeardown.start_workers",
    "agac_tpu.controllers.garbagecollector::OrphanTeardown.stop_workers",
    "agac_tpu.controllers.garbagecollector::_owner_returned",
    "agac_tpu.controllers.garbagecollector::GarbageCollector._owner_object",
    "agac_tpu.controllers.garbagecollector::GarbageCollector._tear_down_owner",
    "agac_tpu.controllers.garbagecollector::GarbageCollector._tear_down_accelerators",
    "agac_tpu.manager::Manager._orphan_teardown",
    "agac_tpu.cloudprovider.aws.cache::DiscoveryCache.refresh",
    "agac_tpu.cloudprovider.aws.cache::DiscoveryCache.invalidate_keeping_tags",
    "agac_tpu.cloudprovider.aws.cache::DiscoveryCache._known_tags",
    "agac_tpu.cloudprovider.aws.cache::DiscoveryCache._forget_kept_tags",
    "agac_tpu.cloudprovider.aws.fake_backend::FileBackedFakeAWSBackend.list_accelerators",
    "agac_tpu.cloudprovider.aws.factory::adoption_hooks",
    "agac_tpu.cloudprovider.aws.factory::adoption_hooks.adoption",
    "agac_tpu.cloudprovider.aws.factory::adoption_hooks.resync",
    "agac_tpu.sharding.reports::store_shard_report",
    "agac_tpu.sharding.reports::_token_shards",
    "agac_tpu.sharding.membership::ShardMembership._renew_releasing",
    "agac_tpu.cloudprovider.aws.fake_backend::FileBackedFakeAWSBackend._settle_counts",
    "agac_tpu.cluster.rest::RestClusterClient._open_watch",
    "agac_tpu.cluster.testserver::_Handler._serve_watch.gone",
    # the port-only wall-time instruments and the trace spans they feed
    "agac_tpu.observability.instruments::read_plane_load_seconds",
    "agac_tpu.observability.instruments::read_plane_wait_seconds",
    "agac_tpu.observability.instruments::pending_settle_wait_seconds",
    "agac_tpu.observability.instruments::apiserver_request_duration_seconds",
    "agac_tpu.observability.instruments::fake_aws_lock_seconds",
    "agac_tpu.observability.trace::record",
    "agac_tpu.cloudprovider.aws.cache::_FlightTimer.__init__",
    "agac_tpu.cloudprovider.aws.cache::_FlightTimer.loading",
    "agac_tpu.cloudprovider.aws.cache::_FlightTimer.waited",
    "agac_tpu.reconcile.pending::PendingSettleTable._observe_wait",
    "agac_tpu.reconcile.pending::PendingSettleTable._pop_locked",
    "agac_tpu.cluster.rest::RestClusterClient._timed_send",
    "agac_tpu.cloudprovider.aws.fake_backend::FileBackedFakeAWSBackend._lock_observed",
    # the in-process drift ticker's instruments (ticks, keys, drain) and
    # its deadlines at whole periods from its start
    "agac_tpu.observability.instruments::drift_ticks_total",
    "agac_tpu.observability.instruments::drift_tick_keys_total",
    "agac_tpu.observability.instruments::drift_tick_drain_seconds",
    "agac_tpu.controllers.common::_DriftTick.__init__",
    "agac_tpu.controllers.common::_DriftTick.shed",
    "agac_tpu.controllers.common::_DriftTick.expect",
    "agac_tpu.controllers.common::_DriftTick.finished",
    "agac_tpu.controllers.common::_DriftTick.close",
    "agac_tpu.controllers.common::_TickSchedule.__init__",
    "agac_tpu.controllers.common::_TickSchedule.until_next",
    # an accelerator-level drift repair folded into the discovery
    # snapshot, not dropping it
    "agac_tpu.cloudprovider.aws.driver::AWSDriver._discovery_retagged",
    "agac_tpu.reconcile.workqueue::watch_adds",
    "agac_tpu.reconcile.workqueue::RateLimitingQueue._watch_add_locked",
    "agac_tpu.reconcile.workqueue::RateLimitingQueue._drains_begin_locked",
    "agac_tpu.reconcile.workqueue::RateLimitingQueue._drains_done_locked",
    # the binding's weight sync, counted where it writes and where it
    # skips a weight the pass already saw in AWS
    "agac_tpu.observability.instruments::binding_weight_sync_total",
    # a staged create answers its own chain from a pending-create record
    # of the topology cache, counted per read it does without
    "agac_tpu.observability.instruments::chain_create_reads_skipped_total",
    "agac_tpu.cloudprovider.aws.cache::AcceleratorTopologyCache.begin_create",
    "agac_tpu.cloudprovider.aws.cache::AcceleratorTopologyCache.end_create",
    "agac_tpu.cloudprovider.aws.cache::AcceleratorTopologyCache._end_create_locked",
    "agac_tpu.cloudprovider.aws.driver::AWSDriver._topology_end_create",
})
PACKAGES = ("agac_tpu", "agac_tpu_torch")
INSTALLED = frozenset({"yaml", "pytest"})
_POSITION = re.compile(r":\d+$")


def _analysis(package: str, module: str):
    return importlib.import_module(f"{package}.analysis.{module}")


def _positionless(obj, package: str):
    """``obj`` with the package name mapped to the reference's and every
    source position dropped."""
    if isinstance(obj, dict):
        return {
            _positionless(k, package): _positionless(v, package)
            for k, v in obj.items()
            if k not in ("path", "line")
        }
    if isinstance(obj, list):
        return [_positionless(v, package) for v in obj]
    if isinstance(obj, str):
        return _POSITION.sub("", obj.replace(package, "agac_tpu"))
    return obj


@pytest.fixture(scope="module")
def analysed():
    """Each package's program, findings and blocks, built by its own
    analyses over its own tree; the port's without
    ``PORT_ONLY_FUNCTIONS``."""
    out = {}
    for package in PACKAGES:
        program_mod = _analysis(package, "program")
        rules = program_mod._load_analyses()
        program = program_mod.Program.build([REPO / package], program_mod.ParseCache())
        if package != "agac_tpu":
            _take_out(program, {f.replace("agac_tpu", package, 1) for f in PORT_ONLY_FUNCTIONS})
        findings, blocks = program_mod.run_analyses(program, rules)
        out[package] = (program, findings, blocks)
    return out


def _take_out(program, fqns: set[str]) -> None:
    """Remove the functions ``fqns`` from ``program``: a call of one
    resolves to nothing, as in a tree without it."""
    for fqn in fqns:
        finfo = program.functions.pop(fqn)
        program.by_name[finfo.name].remove(fqn)
        scopes = [finfo.module.functions]
        if finfo.class_name is not None:
            scopes.append(finfo.module.classes[finfo.class_name].methods)
        for scope in scopes:
            for key in [k for k, v in scope.items() if v is finfo]:
                del scope[key]
    program._callees.clear()


# ---------------------------------------------------------------------------
# 1. the program analyses over both trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("analysis", ["lock-order", "census", "determinism", "confinement"])
def test_program_analysis_blocks_are_equal(analysed, analysis):
    ref = _positionless(analysed["agac_tpu"][2][analysis], "agac_tpu")
    port = _positionless(analysed["agac_tpu_torch"][2][analysis], "agac_tpu_torch")
    assert ref, analysis
    differing = sorted(k for k in set(ref) | set(port) if ref.get(k) != port.get(k))
    assert differing == []


def test_lock_graph_is_not_empty_and_equal(analysed):
    ref = analysed["agac_tpu"][2]["lock-order"]
    port = _positionless(analysed["agac_tpu_torch"][2]["lock-order"], "agac_tpu_torch")
    assert len(ref["locks"]) > 10 and ref["edges"]
    assert port["edges"] == ref["edges"]
    assert port["locks"] == _positionless(ref["locks"], "agac_tpu")


def test_program_findings_are_equal(analysed):
    keys = {
        package: sorted(_positionless(f.key, package) for f in analysed[package][1])
        for package in PACKAGES
    }
    assert keys["agac_tpu_torch"] == keys["agac_tpu"]
    assert len(keys["agac_tpu"]) == 1  # the grandfathered retry jitter


def test_the_port_adds_only_graft_entry(analysed):
    ref = set(analysed["agac_tpu"][0].modules)
    port = {_positionless(m, "agac_tpu_torch") for m in analysed["agac_tpu_torch"][0].modules}
    assert port - ref == {"agac_tpu.graft_entry"}
    assert ref - port == set()


# ---------------------------------------------------------------------------
# 2. the package-scoped rules under either root
# ---------------------------------------------------------------------------

# (rule, seeded source, a path where it fires, paths its scope exempts)
SCOPED_RULES = [
    (
        "unseamed-clock",
        """
        import time

        def deadline():
            return time.monotonic() + 1.0
        """,
        "controllers/bad.py",
        [
            "clockseam.py",
            "sim/runtime.py",
            "cluster/rest.py",
            "cluster/testserver.py",
            "cloudprovider/aws/real_backend.py",
            "cloudprovider/aws/sigv4.py",
        ],
    ),
    (
        "cross-boundary-capture",
        """
        def fan_out(pool, items):
            return [pool.submit(lambda: item) for item in items]
        """,
        "cloudprovider/aws/bad.py",
        ["sim/fan.py", "analysis/fan.py"],
    ),
    (
        "untapped-external-input",
        """
        def pump(self, informer, events):
            for event in events:
                informer.apply_event(event)
        """,
        "sim/pump.py",
        ["sim/capture.py", "sim/replay.py"],
    ),
]


def _rules_at(package: str, source: str, path: str) -> list[str]:
    lint = _analysis(package, "lint")
    return [
        v.rule
        for v in lint.lint_source(textwrap.dedent(source), pathlib.Path(path), INSTALLED)
    ]


@pytest.mark.parametrize(
    "rule,source,bad,exempt", SCOPED_RULES, ids=[r[0] for r in SCOPED_RULES]
)
def test_scoped_rule_fires_alike_under_both_roots(rule, source, bad, exempt):
    reference = _rules_at("agac_tpu", source, f"agac_tpu/{bad}")
    assert reference == [rule]
    for root in PACKAGES:
        assert _rules_at("agac_tpu_torch", source, f"{root}/{bad}") == reference, root
        for rel in exempt:
            assert _rules_at("agac_tpu", source, f"agac_tpu/{rel}") == [], rel
            assert _rules_at("agac_tpu_torch", source, f"{root}/{rel}") == [], (root, rel)
    # outside every package root the rules stay quiet, as the reference's
    assert _rules_at("agac_tpu_torch", source, f"tests/{bad.rpartition('/')[2]}") == (
        _rules_at("agac_tpu", source, f"tests/{bad.rpartition('/')[2]}")
    )


SPAWNER = """
    import threading

    CACHE = {}


    def remember(key, value):
        CACHE[key] = value


    def start(fn):
        threading.Thread(target=fn).start()
"""
# worker.py is in scope of both analyses; the rest are exempt from the
# census (sim/, analysis/) or the thread gate (all four) by path
SPAWNER_FILES = ("worker.py", "sim/runner.py", "analysis/tool.py", "clockseam.py", "cluster/testserver.py")


def _fixture_findings(tmp_path, package: str, root: str) -> list[str]:
    base = tmp_path / package / root
    for rel in ("__init__.py", "sim/__init__.py", "analysis/__init__.py", "cluster/__init__.py"):
        (base / rel).parent.mkdir(parents=True, exist_ok=True)
        (base / rel).write_text("")
    for rel in SPAWNER_FILES:
        (base / rel).write_text(textwrap.dedent(SPAWNER))
    program_mod = _analysis(package, "program")
    program = program_mod.Program.build([base], program_mod.ParseCache())
    findings, _ = program_mod.run_analyses(program, program_mod._load_analyses())
    return sorted(_positionless(f.key, root) for f in findings)


def test_program_scopes_match_under_both_roots(tmp_path):
    reference = _fixture_findings(tmp_path, "agac_tpu", "agac_tpu")
    assert reference == [
        "shared-state-census::agac_tpu.clockseam.CACHE",
        "shared-state-census::agac_tpu.cluster.testserver.CACHE",
        "shared-state-census::agac_tpu.worker.CACHE",
        "unseamed-thread::agac_tpu.worker::start::fn",
    ]
    for root in PACKAGES:
        assert _fixture_findings(tmp_path, "agac_tpu_torch", root) == reference, root
    # the reference's literal scopes miss the port's root: there its
    # exemptions do not apply, which is what the port's scopes repair
    assert _fixture_findings(tmp_path, "agac_tpu", "agac_tpu_torch") != reference


def test_a_target_inside_a_hidden_directory_is_analysed(tmp_path):
    """Hidden and cache directories are skipped below the target only.
    The reference skips every file whose absolute path has a hidden
    part, so a checkout under a hidden directory analyses nothing: its
    gate then fails on a stale baseline, or passes over no module."""
    pkg = tmp_path / ".checkout" / "pkg"
    for rel in ("__init__.py", "a.py", ".hidden/b.py", "__pycache__/c.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text("")
    port = _analysis("agac_tpu_torch", "program")
    assert [p.relative_to(pkg).as_posix() for p in port.iter_python_files([pkg])] == [
        "__init__.py",
        "a.py",
    ]
    assert _analysis("agac_tpu_torch", "lint").iter_python_files is port.iter_python_files
    assert list(_analysis("agac_tpu", "program").iter_python_files([pkg])) == []


# ---------------------------------------------------------------------------
# 3. the port against itself
# ---------------------------------------------------------------------------


def test_port_lint_is_clean():
    lint = _analysis("agac_tpu_torch", "lint")
    violations = lint.lint_paths([REPO / "agac_tpu_torch"])
    assert violations == [], "\n".join(v.render() for v in violations)


def test_port_program_gate_is_clean_with_its_baseline(analysed):
    program_mod = _analysis("agac_tpu_torch", "program")
    program, findings, blocks = analysed["agac_tpu_torch"]
    baseline = program_mod.Baseline.load(REPO / "agac_tpu_torch" / "analysis" / "baseline.json")
    report = program_mod.build_report(program, findings, blocks, baseline)
    assert program_mod.gate_failures(report) == []
    assert report["gate"]["clean"]
    assert report["generated_by"] == "agac_tpu_torch.analysis.program"
    assert report["baseline"]["grandfathered"] == [
        "unseeded-random::agac_tpu_torch.cloudprovider.aws.real_backend"
        "::_SignedClient.request::uniform"
    ]
    # the reference's baseline names the reference's modules: over the
    # port it covers nothing and goes stale
    stale = program_mod.build_report(
        program, findings, blocks, program_mod.Baseline.load(REPO / "analysis_baseline.json")
    )
    assert len(program_mod.gate_failures(stale)) == 2


def test_port_cli_takes_the_reference_arguments(tmp_path, capsys):
    program_mod = _analysis("agac_tpu_torch", "program")
    report = tmp_path / "report.json"
    rc = program_mod.main(
        [
            str(REPO / "agac_tpu_torch"),
            "--report", str(report),
            "--baseline", str(REPO / "agac_tpu_torch" / "analysis" / "baseline.json"),
        ]
    )
    assert rc == 0, capsys.readouterr().out
    assert json.loads(report.read_text())["gate"]["clean"]
    lint = _analysis("agac_tpu_torch", "lint")
    assert lint.main([str(REPO / "agac_tpu_torch")]) == 0


# ---------------------------------------------------------------------------
# 4. the reference's name-pinning confinement cases, name mapped
# ---------------------------------------------------------------------------

_FAKE_OWNER = "agac_tpu_torch.cloudprovider.aws.fake_backend::FakeAWSBackend"


@pytest.fixture(scope="module")
def port_confinement(analysed):
    confinement = _analysis("agac_tpu_torch", "confinement")
    lockorder = _analysis("agac_tpu_torch", "lockorder")
    program = analysed["agac_tpu_torch"][0]
    return confinement, analysed["agac_tpu_torch"][2]["confinement"], lockorder.LockIndex(program)


def test_api_family_covers_backend_implementations(port_confinement):
    confinement, block, _ = port_confinement
    info = block["stages"][confinement.API_STAGE_FAMILY]
    touched = set(info["touched_classes"])
    assert _FAKE_OWNER in touched
    assert any("real_backend::RealGlobalAcceleratorAPI" in c for c in touched)
    assert any(fqn.endswith("FakeAWSBackend.create_accelerator") for fqn in info["entry_points"])
    assert not any(fqn.endswith("FakeAWSBackend.add_load_balancer") for fqn in info["entry_points"])


@pytest.mark.parametrize(
    "stages,active",
    [
        # a covered write passes
        ({"driver-mutate": {"touched_classes": [_FAKE_OWNER]}}, ("driver-mutate",)),
        # stages nest (aws:* inside driver-mutate): any open bracket covering suffices
        (
            {
                "driver-mutate": {"touched_classes": [_FAKE_OWNER]},
                "aws:*": {"touched_classes": []},
            },
            ("driver-mutate", "aws:globalaccelerator.create_accelerator"),
        ),
        # per-operation stage names normalize to the aws:* family
        (
            {"aws:*": {"touched_classes": [_FAKE_OWNER]}},
            ("aws:route53.change_resource_record_sets",),
        ),
    ],
    ids=["covered-write", "any-active-stage", "api-stage-family"],
)
def test_runtime_crosscheck_with_the_port_owner(port_confinement, stages, active):
    confinement, _, index = port_confinement
    violations, unmapped = confinement.crosscheck_stage_accesses(
        stages, index, [(active, "fake-backend._accelerators")]
    )
    assert violations == []
    assert unmapped == []
    # the reference's name owns nothing in the port's program
    reference_owner = {
        name: {"touched_classes": [c.replace("agac_tpu_torch", "agac_tpu") for c in info["touched_classes"]]}
        for name, info in stages.items()
    }
    violations, _ = confinement.crosscheck_stage_accesses(
        reference_owner, index, [(active, "fake-backend._accelerators")]
    )
    assert len(violations) == 1 and "blind spot" in violations[0]


# ---------------------------------------------------------------------------
# 5. chip_smoke.py's analysis phase, at a small size
# ---------------------------------------------------------------------------


def test_chip_smoke_analysis_phase_on_a_small_fleet():
    import chip_smoke

    result = chip_smoke.phase_analysis(20, "cpu")
    static, crosscheck = result["static"], result["crosscheck"]
    assert static["lint_violations"] == static["gate_failures"] == 0
    assert static["grandfathered"] == static["findings"] == 1
    assert crosscheck["faults_injected"] > 0
    assert crosscheck["lock_violations"] == crosscheck["footprint_violations"] == 0
    assert crosscheck["stage_accesses"] > 0
