"""The port's measurement harness (``ps_pytorch_tpu_torch/bench_suite.py``,
``bench.py``, ``tools/regress.py``, ``tools/report.py``) against the JAX
package's (the root ``bench_suite.py`` and ``bench.py``, its
``tools/regress.py`` and ``tools/report.py``) on the CPU, at small size.

- ``CONFIGS`` has the JAX suite's 49 names, in its order.
- A LeNet throughput row has the JAX row's keys plus ``device_kind``,
  ``backend`` and ``mask``; the
  host rows' wire (``payload_sha256``, ``wire_mb``), ZeRO parameters
  (``params_sha256``) and homomorphic averages (``bitwise_identical``)
  equal the JAX rows' for the same seed and geometry; the hierarchy row's
  groups and error agree.
- ``main``'s derived rows and markdown, fed the same rows, equal the JAX
  ``main``'s.
- The gate and the report give the JAX verdicts on the repo's committed
  artifacts and on the drills' fixtures, and the gate never judges a card
  row against a TPU one, nor a row over four ranks against one over one.
- ``bench.py``'s parent prints one line on success and on failure, exits
  non-zero without a card, and runs one child (no CPU rung).

No test times anything: timing-dependent ``ok`` flags are not asserted.
"""

import argparse
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import bench as jax_bench
import bench_suite as jax_suite
from ps_pytorch_tpu.tools import regress as jax_regress
from ps_pytorch_tpu.tools import report as jax_report
from ps_pytorch_tpu_torch import bench, bench_suite
from ps_pytorch_tpu_torch.tools import regress, report
from test_torch_drills import (
    FAILOVER_LOGS, LOAD, REBALANCE_LOGS, _elastic_args, _finals,
    _kvrep_logs, _poison_args, _poison_logs,
)
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench_suite, "DEVICE", "cpu")


def test_configs_are_the_jax_configs():
    assert list(bench_suite.CONFIGS) == list(jax_suite.CONFIGS)
    assert len(bench_suite.CONFIGS) == 49


def test_lenet_row_has_the_jax_keys_and_device_kind():
    ours = bench_suite.bench_throughput(
        "lenet_mnist_single", "LeNet", "synthetic_mnist", 16, 2,
        n_devices=1)
    want = jax_suite.bench_throughput(
        "lenet_mnist_single", "LeNet", "synthetic_mnist", 16, 2,
        n_devices=1)
    assert set(ours) == set(want) | {"device_kind", "backend", "mask"}
    assert (ours["backend"], ours["mask"]) == ("none", [1])
    assert set(ours["phases"]) == set(want["phases"])
    assert (ours["platform"], ours["device_kind"]) == ("cpu", "cpu")
    assert ours["devices"] == want["devices"] == 1
    assert ours["global_batch"] == want["global_batch"] == 16
    assert ours["phases"]["host_dispatch"]["count"] == 2
    assert "launches" not in ours       # the plain versions count nothing
    with pytest.raises(ValueError, match="tools/launch.py"):
        bench_suite.bench_throughput("lenet_mnist_dp", "LeNet",
                                     "synthetic_mnist", 16, 1, n_devices=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_suite.bench_throughput("lenet_mnist_single", "LeNet",
                                     "synthetic_mnist", 16, 1,
                                     device="cuda")


WIRE = dict(payload_mb=1, leaf_kb=256, rtt_ms=0.0)
CODEC = dict(payload_mb=1, leaf_kb=256, contributors=3, rtt_ms=0.0,
             bucket_mb=0.5, workers=2)
HOST_ROWS = [
    ("bench_wire", dict(WIRE, bucket_mb=0, workers=0),
     ("payload_sha256", "wire_mb", "buckets", "leaves")),
    ("bench_wire", dict(WIRE, bucket_mb=0.5, workers=2),
     ("payload_sha256", "wire_mb", "buckets", "leaves")),
    ("bench_codec_agg", dict(CODEC, codec="blosc"),
     ("wire_mb", "raw_mb", "agg_rel_err", "bitwise_identical")),
    ("bench_codec_agg", dict(CODEC, codec="int8lat"),
     ("wire_mb", "raw_mb", "agg_rel_err", "bitwise_identical")),
    ("bench_codec_agg", dict(CODEC, codec="topk"),
     ("wire_mb", "raw_mb", "agg_rel_err", "bitwise_identical")),
    ("bench_zero", dict(n_shards=1, payload_mb=1, leaf_kb=256, rtt_ms=0.0),
     ("params_sha256", "wire_out_mb_max", "wire_in_mb_max",
      "opt_state_mb_max")),
    ("bench_zero", dict(n_shards=2, payload_mb=1, leaf_kb=256, rtt_ms=0.0,
                        optimizer="adam"),
     ("params_sha256", "wire_out_mb_max", "wire_in_mb_max",
      "opt_state_mb_max")),
]


@pytest.mark.parametrize("fn,kw,keys", HOST_ROWS,
                         ids=[f"{f}-{i}" for i, (f, _, _) in
                              enumerate(HOST_ROWS)])
def test_host_rows_equal_the_jax_rows(fn, kw, keys):
    ours = getattr(bench_suite, fn)("r", 2, **kw)
    want = getattr(jax_suite, fn)("r", 2, **kw)
    assert set(ours) == set(want)
    assert ours["platform"] == want["platform"] == "host"
    for key in keys:
        assert ours[key] == want[key], key
    if kw.get("codec") in ("int8lat", "topk"):
        assert ours["bitwise_identical"] is True


def test_hier_row_agrees_with_the_jax_row():
    kw = dict(codec="int8lat", payload_mb=1, leaf_kb=256, n_slices=4,
              group_size=2, intra_rtt_ms=0.0, inter_rtt_ms=0.0)
    ours = bench_suite.bench_hier_agg("ht", 1, **kw)
    want = jax_suite.bench_hier_agg("ht", 1, **kw)
    assert set(ours) == set(want)
    assert ours["n_groups"] == want["n_groups"] == 2
    assert (ours["flat_kv_ops"], ours["hier_kv_ops"]) == \
        (want["flat_kv_ops"], want["hier_kv_ops"])
    assert ours["rel_err"] < 0.02 and want["rel_err"] < 0.02
    assert ours["rel_err"] == pytest.approx(want["rel_err"], abs=1e-6)


FABRICATED = [
    {"config": "resnet18_cifar10_dp", "images_per_sec": 1000.0,
     "devices": 1, "global_batch": 1024, "sec_per_step": 1.024,
     "vs_baseline": 2.41},
    {"config": "input_pipeline", "loader_images_per_sec": 2500.0},
    {"config": "resnet50_imagenet", "images_per_sec": 700.0, "devices": 1,
     "global_batch": 32, "sec_per_step": 0.0457, "vs_baseline": None},
    {"config": "input_pipeline_imagenet", "loader_images_per_sec": 900.0},
    {"config": "wire_blocking_8mb", "total_s": 2.0, "payload_sha256": "a"},
    {"config": "wire_overlapped_8mb", "total_s": 1.5,
     "payload_sha256": "a"},
    {"config": "wire_blocking_64mb", "total_s": 8.0, "payload_sha256": "b"},
    {"config": "wire_overlapped_64mb", "total_s": 4.0,
     "payload_sha256": "c"},
    {"config": "wire_codec_blosc_24mb", "wire_mb": 90.0, "total_s": 3.0},
    {"config": "wire_codec_int8lat_24mb", "wire_mb": 26.0, "total_s": 2.0,
     "bitwise_identical": True, "agg_rel_err": 0.01},
    {"config": "wire_codec_topk_24mb", "wire_mb": 2.0, "total_s": 1.0,
     "bitwise_identical": True, "agg_rel_err": 0.9},
    {"config": "hier_sync_4slice", "n_slices": 4, "n_groups": 2,
     "flat_s": 2.0, "hier_s": 1.0, "speedup": 2.0, "rel_err": 0.01},
    {"config": "hier_sync_9slice", "n_slices": 9, "n_groups": 3,
     "flat_s": 1.0, "hier_s": 2.0, "speedup": 0.5, "rel_err": 0.01},
    {"config": "zero_wire_1shard", "shards": 1, "wire_out_mb_max": 30.0,
     "opt_state_mb_max": 24.0, "total_s": 1.0, "params_sha256": "p"},
    {"config": "zero_wire_2shard", "shards": 2, "wire_out_mb_max": 15.0,
     "opt_state_mb_max": 12.0, "total_s": 0.8, "params_sha256": "p"},
    {"config": "zero_wire_4shard", "shards": 4, "wire_out_mb_max": 8.0,
     "opt_state_mb_max": 6.0, "total_s": 0.7, "params_sha256": "q"},
    {"config": "serve_sequential_8", "tokens_per_sec": 100.0,
     "tokens_sha256": "t", "ttft_p99_ms": 5.0, "latency_p99_ms": 50.0},
    {"config": "serve_batched_8", "tokens_per_sec": 400.0,
     "tokens_sha256": "t", "ttft_p99_ms": 9.0, "latency_p99_ms": 60.0},
    {"config": "lenet_convergence", "seconds": 1.5, "converged": True,
     "steps": 12},
    {"config": "resnet18_zero1", "error": "RuntimeError: fabricated"},
]


def _printed_main(mod, monkeypatch, capsys, md):
    names = []
    for row in FABRICATED:
        monkeypatch.setitem(mod.CONFIGS, row["config"],
                            lambda steps, row=row: dict(row))
        names.append(row["config"])
    assert mod.main(["--configs", ",".join(names), "--markdown",
                     str(md)]) == 0
    return ([json.loads(line) for line in
             capsys.readouterr().out.splitlines()], md.read_text())


def test_main_derives_the_jax_rows(monkeypatch, capsys, tmp_path):
    ours, ours_md = _printed_main(bench_suite, monkeypatch, capsys,
                                  tmp_path / "ours.md")
    want, want_md = _printed_main(jax_suite, monkeypatch, capsys,
                                  tmp_path / "want.md")
    assert ours == want and ours_md == want_md
    derived = {r["config"] for r in ours[len(FABRICATED):]}
    assert derived == {
        "loader_vs_chip_demand", "loader_vs_chip_demand_imagenet",
        "wire_overlap_win_8mb", "wire_overlap_win_64mb",
        "wire_codec_win_int8lat_24mb", "wire_codec_win_topk_24mb",
        "hierarchy_win_4slice", "hierarchy_win_9slice",
        "zero_wire_win_2shard", "zero_wire_win_4shard",
        "serve_batch_win_8"}


# ---------------------------------------------------------- the gate --

def test_gate_and_report_equal_the_jax_tools_on_the_repo():
    assert regress.run_all(str(REPO)) == jax_regress.run_all(str(REPO))
    assert report.collect(str(REPO)) == jax_report.collect(str(REPO))


def _drill_artifacts():
    from ps_pytorch_tpu_torch.tools import (
        elastic_drill, kvrep_drill, poison_drill,
    )
    elastic = elastic_drill.build_artifact(
        _elastic_args(), elastic_drill.parse_failover(FAILOVER_LOGS, 1),
        elastic_drill.parse_rebalance(REBALANCE_LOGS, 0))
    bitwise = {"ok": True, "bitwise_equal": True}
    bench_row = {"ok": True, "baseline_s": 0.01, "integrity_s": 0.0101,
                 "overhead_frac": 0.01}
    legs = (poison_drill.parse_clean(_finals("2.3"), 0),
            poison_drill.parse_poison(_poison_logs(), 0, 2.3),
            poison_drill.parse_poison_ef(_poison_logs(), 0),
            poison_drill.parse_control(_finals("nan"), 0, 2.3), bitwise)
    train = kvrep_drill.parse_train(_kvrep_logs(), 0, {
        "killed": True, "wiped": True, "kill_at_s": 1.5}, True, 144,
        False, 24)
    serve = kvrep_drill.serve_section(LOAD, 60, 3, 6, 6, 2)
    kv_bitwise = dict(bitwise, kills=1, wipes=1, rejoins=1, resyncs=1)
    overhead = {"ok": True, "overhead_frac": 0.01, "budget": 0.05}
    return [
        ("elastic", elastic),
        ("integrity", poison_drill.build_artifact(_poison_args(), *legs,
                                                  bench_row)),
        ("integrity", poison_drill.build_artifact(_poison_args(), *legs)),
        ("kvrep", kvrep_drill.build_artifact(
            argparse.Namespace(device="cpu"), train, serve, kv_bitwise,
            overhead)),
        ("kvrep", kvrep_drill.build_artifact(
            argparse.Namespace(device="cpu"), train, serve, kv_bitwise)),
    ]


def _committed_pairs():
    """(family, baseline, candidate) for every family: its newest
    committed artifact (with the family's section or rows), against the
    round before where there is one."""
    pairs = []
    for family in jax_regress.FAMILIES:
        paths = jax_regress._committed(family, str(REPO))
        docs = [jax_regress.load_artifact(p) for p in paths]
        if family in ("elastic", "hierarchy", "router", "integrity",
                      "kvrep"):
            docs = [d for d in docs if isinstance(d, dict) and family in d]
        assert docs, family
        pairs.append((family, docs[-2] if len(docs) > 1 else None, docs[-1]))
    return pairs


def test_every_family_compares_as_the_jax_gate():
    pairs = _committed_pairs()
    assert {f for f, _, _ in pairs} == set(jax_regress.FAMILIES)
    assert len(jax_regress.FAMILIES) == len(regress.FAMILIES) == 13
    for family, base, cand in pairs + [(f, None, a) for f, a in
                                       _drill_artifacts()]:
        if base is None and family in ("wire", "serve", "suite"):
            base = cand
        assert regress.compare(family, base, cand) == \
            jax_regress.compare(family, base, cand), family


def _rows_file(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


H100 = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"}


def test_a_card_row_is_never_judged_against_a_tpu_row(tmp_path):
    shutil.copy(REPO / "BENCH_SUITE_r03.json", tmp_path)
    cand = _rows_file(tmp_path / "cand.json", [
        dict(H100, config="resnet18_cifar10_dp", images_per_sec=10.0)])
    verdict = regress.run_gate("suite", cand, repo=str(tmp_path))
    assert verdict == {"family": "suite", "ok": True, "configs": {},
                       "note": "no committed baseline; gate passes"}
    explicit = regress.run_gate("suite", cand, repo=str(tmp_path),
                                baseline_path=str(tmp_path /
                                                  "BENCH_SUITE_r03.json"))
    assert explicit == verdict
    # The JAX gate compares them, and fails the slow row.
    assert not jax_regress.run_gate("suite", cand, repo=str(tmp_path))["ok"]
    # A baseline of the same card is compared.
    _rows_file(tmp_path / "BENCH_SUITE_r30.json", [
        dict(H100, config="resnet18_cifar10_dp", images_per_sec=100.0),
        {"config": "input_pipeline", "platform": "host",
         "loader_images_per_sec": 5.0}])
    verdict = regress.run_gate("suite", cand, repo=str(tmp_path))
    assert verdict["baseline"] == "BENCH_SUITE_r30.json"
    assert not verdict["ok"]
    assert verdict["configs"]["resnet18_cifar10_dp"]["metrics"][
        "images_per_sec"]["ratio"] == 0.1
    # Host rows keep the JAX rule.
    shutil.copy(REPO / "BENCH_WIRE_r13.json", tmp_path)
    host = _rows_file(tmp_path / "host.json", [
        {"config": "wire_blocking_8mb", "platform": "host", "total_s": 9.9,
         "publish_s": 5.0, "read_s": 4.9}])
    assert regress.run_gate("wire", host, repo=str(tmp_path)) == \
        jax_regress.run_gate("wire", host, repo=str(tmp_path))


def test_a_row_over_four_ranks_is_never_judged_against_one_rank(tmp_path):
    one = _rows_file(tmp_path / "BENCH_SUITE_r30.json", [
        dict(H100, config="resnet18_cifar10_dp", devices=1,
             images_per_sec=100.0)])
    cand = _rows_file(tmp_path / "cand.json", [
        dict(H100, config="resnet18_cifar10_dp", devices=4,
             images_per_sec=10.0)])
    assert regress.chip_devices(regress.load_artifact(one)) == {
        ("gpu", H100["device_kind"], 1)}
    verdict = regress.run_gate("suite", cand, repo=str(tmp_path))
    assert verdict == {"family": "suite", "ok": True, "configs": {},
                       "note": "no committed baseline; gate passes"}
    assert regress.run_gate("suite", cand, repo=str(tmp_path),
                            baseline_path=one) == verdict
    # A baseline over the same four ranks is compared, and the slow row
    # fails.
    _rows_file(tmp_path / "BENCH_SUITE_r31.json", [
        dict(H100, config="resnet18_cifar10_dp", devices=4,
             images_per_sec=100.0)])
    verdict = regress.run_gate("suite", cand, repo=str(tmp_path))
    assert verdict["baseline"] == "BENCH_SUITE_r31.json"
    assert not verdict["ok"]


def test_report_takes_a_card_headline_as_measured(tmp_path):
    (tmp_path / "BENCH_r30_headline.json").write_text(json.dumps(
        dict(H100, value=5000.0, unit="images/sec", mfu=0.05,
             vs_baseline=12.0)))
    ours = {e["family"]: e for e in report.collect(str(tmp_path))}
    want = {e["family"]: e for e in jax_report.collect(str(tmp_path))}
    assert ours["headline capture"]["ok"] is True
    assert want["headline capture"]["ok"] is False
    assert {k: v for k, v in ours["headline capture"].items()
            if k != "ok"} == {k: v for k, v in
                              want["headline capture"].items() if k != "ok"}


# ------------------------------------------------------------ bench.py --

def _args(**over):
    d = dict(per_device_batch=16, steps=1, warmup=1, timeout=60.0,
             extras=False, device="cpu", ranks=1)
    d.update(over)
    return argparse.Namespace(**d)


def _fake(monkeypatch, result):
    calls = []

    def run_attempt(args):
        calls.append(args.device)
        return result

    monkeypatch.setattr(bench, "_run_attempt", run_attempt)
    return calls


def _line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_parent_prints_one_line_on_success(monkeypatch, capsys):
    calls = _fake(monkeypatch, ({"metric": bench.METRIC, "value": 5.0,
                                 "unit": "images/sec"}, None))
    assert bench.parent_main(_args()) == 0
    assert _line(capsys)["value"] == 5.0
    assert calls == ["cpu"]


def test_parent_prints_one_line_on_failure_with_no_cpu_rung(monkeypatch,
                                                            capsys):
    calls = _fake(monkeypatch, (None, "child: rc=1: boom"))
    assert bench.parent_main(_args()) == 1
    out = _line(capsys)
    assert out["error"] == "child: rc=1: boom" and out["value"] == 0.0
    assert out["metric"] == jax_bench.METRIC
    assert "fallback" not in out and "attempts" not in out
    assert calls == ["cpu"]             # one child; no other rung


def test_parent_without_a_card_exits_non_zero(monkeypatch, capsys):
    calls = _fake(monkeypatch, ({"metric": bench.METRIC}, None))
    assert bench.parent_main(_args(device="cuda")) == 1
    assert "CUDA is not available" in _line(capsys)["error"]
    assert calls == []


def test_child_prints_the_jax_headline_keys(capsys):
    assert bench.child_main(_args()) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    assert first == last and bench._last_metric_line("\n".join(lines)) \
        == last
    assert set(last) == {
        "metric", "value", "unit", "vs_baseline", "sec_per_step", "mfu",
        "flops_per_image_gf", "global_batch", "devices", "backend",
        "platform", "device_kind", "init_s", "compile_s", "baseline_note"}
    assert last["metric"] == jax_bench.METRIC
    assert (last["platform"], last["mfu"], last["global_batch"],
            last["devices"], last["backend"]) == ("cpu", None, 16, 1, "none")
    assert last["vs_baseline"] == round(
        last["value"] / jax_bench.BASELINE_IMGS_PER_SEC, 2)
    assert np.isfinite(last["flops_per_image_gf"])
