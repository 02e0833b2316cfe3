"""The readers of the program's own spans and counters (benchmark/
program.py, metrics/recon.{upload_ms,upload_mb,syncs,to_host_ms,
weld_ms}.py): reported in their cells' traced runs only, and silent, not
raising, on a program that records nothing."""

from __future__ import annotations

import json

import pytest

import tiny
from benchmark import harness

NEW = {"recon.upload_ms", "recon.upload_mb", "recon.syncs",
       "recon.to_host_ms", "recon.weld_ms"}
CELLS = {"recon.captures": NEW - {"recon.weld_ms"},
         "recon.orbit": NEW - {"recon.weld_ms"},
         "recon.mesh": NEW - {"recon.to_host_ms"}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("program_trace"),
                          recon_objects=("cone_blue",))


@pytest.mark.parametrize("cell", list(CELLS))
def test_each_metric_reads_in_its_cells_only(root, cell, capsys):
    from benchmark import run
    for trace in (0, 1):
        assert run.main(["--workload", cell, "--seed", "3000000019",
                         "--seconds", "0.2", "--trace", str(trace)],
                        device="cpu", root=root) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["correct"]
        got = NEW & set(res["metrics"])
        assert got == (CELLS[cell] if trace else set())
        if trace:
            for name in got - {"recon.upload_mb", "recon.syncs"}:
                assert res["metrics"][name]["value"] > 0, name


def test_readers_are_silent_on_a_program_without_records(root):
    base = root / "benchmark"
    untraced = {"stages": [{"auto_volume": 0.1, "fuse": 0.2,
                            "extract": 0.3}]}
    for ctx in ({}, {"stages": []}, untraced):
        for name in NEW:
            assert harness.reader(name, base)(ctx) is None


def test_means_are_per_object():
    from benchmark.program import count_mean, span_ms
    rec = [{"trace": {"spans": [["fuse.upload", "recon.fuse", 0, 2e6],
                                ["extract.to_host", "recon.extract", 0, 1e6],
                                ["extract.floor", "recon.extract", 0, 1e6]],
                      "counts": {"syncs": 11, "h2d_bytes": 5}}},
           {"trace": {"spans": [["fuse.upload", "recon.fuse", 5, 4e6 + 5]],
                      "counts": {"syncs": 13}}}]
    ctx = {"stages": rec}
    assert span_ms(ctx, "fuse.upload") == pytest.approx(3.0)
    assert span_ms(ctx, "extract.to_host", "extract.floor") == \
        pytest.approx(2.0)
    assert span_ms(ctx, "extract.weld") is None
    assert count_mean(ctx, "syncs") == 12 and count_mean(ctx, "h2d_bytes") \
        == 2.5
