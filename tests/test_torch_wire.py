"""The wire and process slice, held against the reference: the same
inputs through ``agac_tpu`` and ``agac_tpu_torch`` give the same
manifests, command-line help, SigV4 headers, metric catalog, and the
same Events and explain verdicts from two controller processes and the
webhook run as the chart runs them (``chip_smoke.process`` at 20
Services and 2 Ingresses).

The port, the reference and ``chip_smoke`` are imported inside the
tests only (the repository's linter treats the port as third party)."""

from __future__ import annotations

import datetime
import importlib
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("agac_tpu", "agac_tpu_torch")


def _tree(root: pathlib.Path) -> dict[str, bytes]:
    return {
        p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()
    }


def test_manifests_equal_the_reference_and_config(tmp_path):
    trees = {}
    for package in PACKAGES:
        out = tmp_path / package
        result = subprocess.run(
            [sys.executable, "-m", package, "manifests", "-o", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert result.returncode == 0, result.stderr
        trees[package] = _tree(out)
    assert trees["agac_tpu_torch"] == trees["agac_tpu"]
    assert trees["agac_tpu_torch"] == _tree(REPO / "config")


def _help_texts(package: str) -> dict[str, str]:
    """The root's and every subcommand's ``--help`` text without its
    whitespace: the reference's help cites its change history by number,
    in parentheses, the port's does not, and the two texts then wrap at
    other places (argparse also breaks lines after hyphens)."""
    import argparse

    parser = importlib.import_module(f"{package}.cmd.root").build_parser()
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    texts = {"": parser.format_help()}
    texts.update({name: p.format_help() for name, p in sub.choices.items()})
    return {
        name: "".join(re.sub(r" \([A-Z]+ \d+\)", "", text).split())
        for name, text in texts.items()
    }


def test_every_help_text_equals_the_reference(monkeypatch):
    monkeypatch.setenv("COLUMNS", "100")
    ref, port = _help_texts("agac_tpu"), _help_texts("agac_tpu_torch")
    assert set(port) == {"", "controller", "webhook", "resize-shards", "explain", "version", "manifests"}
    assert port == ref


REQUESTS = [
    ("POST", "https://globalaccelerator.us-west-2.amazonaws.com/", {
        "Content-Type": "application/x-amz-json-1.1",
        "X-Amz-Target": "GlobalAccelerator_V20180706.ListAccelerators",
    }, b'{"MaxResults": 100}', "globalaccelerator", "us-west-2"),
    ("GET", "https://route53.amazonaws.com/2013-04-01/hostedzone?maxitems=100&marker=Z1%2B",
     {}, b"", "route53", "us-east-1"),
    ("POST", "https://elasticloadbalancing.us-west-2.amazonaws.com/",
     {"Content-Type": "application/x-www-form-urlencoded; charset=utf-8"},
     b"Action=DescribeLoadBalancers&Names.member.1=web&Version=2015-12-01",
     "elasticloadbalancing", "us-west-2"),
]


@pytest.mark.parametrize("session_token", [None, "FQoGZXIvYXdzEXAMPLE"])
def test_sigv4_headers_equal_the_reference(session_token):
    now = datetime.datetime(2026, 3, 1, 12, 34, 56, tzinfo=datetime.timezone.utc)
    signed = {}
    for package in PACKAGES:
        sigv4 = importlib.import_module(f"{package}.cloudprovider.aws.sigv4")
        creds = sigv4.Credentials("AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", session_token)
        signed[package] = [
            sigv4.sign_request(method, url, headers, body, service, region, creds, now=now)
            for method, url, headers, body, service, region in REQUESTS
        ]
    assert signed["agac_tpu_torch"] == signed["agac_tpu"]
    assert all("Signature=" in h["Authorization"] for h in signed["agac_tpu_torch"])


def test_metric_catalog_is_current_for_the_port():
    result = subprocess.run(
        [sys.executable, "-m", "agac_tpu_torch.observability.catalog", "--check",
         "docs/operations.md"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert "metric catalog is current" in result.stdout


@pytest.fixture(scope="module")
def process_runs(tmp_path_factory):
    """``chip_smoke.process`` through each package's command line, at 20
    Services and 2 Ingresses."""
    smoke = importlib.import_module("chip_smoke")
    return {
        package: smoke.process(smoke.load(package), package, 20, tmp_path_factory.mktemp(package))
        for package in PACKAGES
    }


def test_process_phase_equals_the_reference(process_runs):
    ref, port = process_runs["agac_tpu"], process_runs["agac_tpu_torch"]
    assert port["events"] == ref["events"]
    assert port["verdicts"] == ref["verdicts"]
    assert len(port["verdicts"]) == 22 and set(port["verdicts"].values()) == {"converged"}
    # a Route53RecordCreated Event per hostname: Service 0 (every 20th
    # Service has one) and both Ingresses
    assert sum(reason == "Route53RecordCreated" for reason, _, _ in port["events"]) == 3
    assert port["exits"] == ref["exits"]
    assert port["webhook"] == ref["webhook"]
