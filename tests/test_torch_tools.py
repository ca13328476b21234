"""The port's harness tools (``ps_pytorch_tpu_torch/tools/``: analyze,
sweep, scaling_run, memory_probe, accuracy_run, accuracy_codec) held
against the JAX package's on the same inputs, on the CPU.

- ``analyze``: every subcommand's JSON (``--json``; stitch's merged trace)
  on the same STEP logs, metrics JSONL, span files, Chrome traces, flight
  dumps and request traces equals the JAX ``analyze``'s. The inputs are
  written by the port's own writers where it has them (``format_line``,
  ``FlightRecorder``).
- ``sweep``: a trial through ``python -m ps_pytorch_tpu_torch.train``
  reads its STEP lines (the JAX test's case); the grid and ``BEST`` line
  over the same trial results equal the JAX sweep's.
- ``scaling_run``: ``_train_argv`` keeps the JAX modes flag for flag (the
  port adds ``--device``), and the markdown is the JAX one's.
- ``memory_probe`` and ``accuracy_run``: the JAX contracts of
  ``tests/test_probe_tools.py`` (deltas and atomic rewrites, the mode
  list checked before any child, a timeout as a row, nan EVAL lines, the
  corpus, the artifact from faked children), and ``lm_flash``'s step at a
  small geometry (``LM_GEOM`` patched in both modules) against the JAX
  step on the same weights: the loss within 1e-5 for 3 steps.
- ``accuracy_codec``: the JAX ``RUNS``, and its row of a codec sweep.
- No tool writes a JAX artifact; with no card and no ``--device cpu``,
  a tool that runs a model raises.
"""

import json
import re
import subprocess
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from ps_pytorch_tpu.tools import accuracy_codec as jax_accuracy_codec
from ps_pytorch_tpu.tools import accuracy_run as jax_accuracy_run
from ps_pytorch_tpu.tools import analyze as jax_analyze
from ps_pytorch_tpu.tools import memory_probe as jax_memory_probe
from ps_pytorch_tpu.tools import scaling_run as jax_scaling_run
from ps_pytorch_tpu.tools import sweep as jax_sweep
from ps_pytorch_tpu_torch.runtime.metrics import format_line
from ps_pytorch_tpu_torch.telemetry.flightrec import FlightRecorder
from ps_pytorch_tpu_torch.tools import (
    accuracy_codec, accuracy_run, analyze, memory_probe, scaling_run, sweep,
)

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- analyze --

def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _spans(t0=0.0):
    """Wire, codec and zero-wire spans as the Tracer writes them."""
    return [
        {"name": "wire_publish", "t0": t0, "dur": 0.5, "tid": 1,
         "args": {"bytes": 1500, "bytes_raw": 6000, "corr": "w/0/1"}},
        {"name": "wire_encode", "t0": t0, "dur": 0.3, "tid": 2,
         "args": {"bucket": 0, "leaves": 2, "bytes": 1000,
                  "bytes_raw": 4000}},
        {"name": "wire_put", "t0": t0 + 0.3, "dur": 0.3, "tid": 2,
         "args": {"bucket": 0, "bytes": 1000}},
        {"name": "wire_encode", "t0": t0 + 0.1, "dur": 0.2, "tid": 3,
         "args": {"bucket": 1, "leaves": 1, "bytes": 500,
                  "bytes_raw": 2000}},
        {"name": "wire_put", "t0": t0 + 0.3, "dur": 0.2, "tid": 3,
         "args": {"bucket": 1, "bytes": 500}},
        {"name": "wire_read", "t0": t0 + 1.0, "dur": 0.4, "tid": 1,
         "args": {"corr": "w/0/1"}},
        {"name": "wire_decode", "t0": t0 + 1.0, "dur": 0.3, "tid": 2,
         "args": {"bucket": 0, "leaves": 2}},
        {"name": "zw_publish", "t0": t0 + 2.0, "dur": 0.4, "tid": 1},
        {"name": "zw_update", "t0": t0 + 2.0, "dur": 0.2, "tid": 2,
         "args": {"shard": 0}},
        {"name": "zw_put", "t0": t0 + 2.2, "dur": 0.2, "tid": 2,
         "args": {"shard": 0, "bytes": 2048}},
        {"name": "zw_assemble", "t0": t0 + 2.5, "dur": 0.3, "tid": 1},
        {"name": "zw_get", "t0": t0 + 2.5, "dur": 0.25, "tid": 3,
         "args": {"shard": 1, "bytes": 2048}},
        {"name": "step", "t0": t0, "dur": 3.0, "tid": 1},
    ]


def _chrome(spans, pid):
    return {"traceEvents": [
        {"ph": "X", "name": s["name"], "ts": s["t0"] * 1e6,
         "dur": s["dur"] * 1e6, "pid": pid, "tid": s["tid"],
         "args": s.get("args", {})} for s in spans]}


def _flight(path, pid, reason, epoch):
    rec = FlightRecorder(str(path), capacity=16)
    for step in range(1, 4):
        rec.record_step(step, loss=2.0 / step, step_time=0.1 * step)
    rec.record_event("election", {"event": "won", "pid": pid,
                                  "epoch": epoch, "step": 2})
    rec.record_event("membership", {"event": "join", "pid": pid + 1,
                                    "epoch": epoch, "step": 3})
    rec.record_event("shard_replan", {"epoch": epoch, "step": 3})
    rec.dump(reason)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """One set of files of every kind the subcommands read."""
    d = tmp_path_factory.mktemp("analyze")
    logs = {}
    for name, times in (("n1", [9.0, 1.0, 1.0, 1.0]),
                        ("n2_h0", [9.0, 0.6, 0.55, 0.6]),
                        ("n2_h1", [9.0, 0.5, 0.5, 0.45])):
        p = d / f"{name}.log"
        p.write_text("noise\n" + "".join(
            format_line(i, 0, 1.0 / i, 0.5, 2, t, 0.01,
                        examples_per_sec=100.0 / t, data_stall_frac=0.02)
            + "\n" for i, t in enumerate(times, start=1)))
        logs[name] = str(p)
    phases = _jsonl(d / "m.jsonl", [
        {"step": s, "process": p, "step_time": 0.1 * s + 0.01 * p,
         "loss": 1.0, "phases": {"data_wait": 0.01, "host_dispatch": 0.02,
                                 "device_sync": 0.05 * s},
         "kv_retries": s, "kv_drops": s - 1, "crashes": int(s > 2)}
        for s in range(1, 5) for p in range(2)])
    spans = _jsonl(d / "spans.jsonl", _spans())
    serving = _jsonl(d / "serve.jsonl", [
        {"config": "serve_s4", "slots": 4, "tokens_per_sec": 120.5,
         "ttft_p50_ms": 3.0, "ttft_p99_ms": 9.0, "latency_p50_ms": 20.0,
         "latency_p99_ms": 41.0, "ok": True},
        {"config": "serve_batch_win_4", "ratio": 2.5,
         "bitwise_identical": True, "ok": True},
        {"config": "serve_s8", "error": "oom"}])
    flights = [_flight(d / f"flightrec.json.p{p}", p, "crash", 2 + p)
               for p in range(2)]
    traces = []
    for p in range(2):
        path = d / f"trace.json.p{p}"
        path.write_text(json.dumps(_chrome(_spans(p * 0.1), p)))
        traces.append(str(path))
    requests = d / "requests.json"
    requests.write_text(json.dumps({"requests": [
        {"rid": i, "outcome": "ok" if i % 3 else "shed",
         "latency_s": 0.05 * i, "queue_wait_s": 0.01 * i,
         "prefill_s": 0.02, "decode_s": 0.015 * i, "stream_out_s": 0.001,
         "n_tokens": 8, "kept": True} for i in range(1, 7)]}))
    return dict(dir=d, logs=logs, phases=phases, spans=spans,
                serving=serving, flights=flights, traces=traces,
                requests=str(requests))


CASES = {
    "speedups": lambda i: [f"1={i['logs']['n1']}",
                           f"2={i['dir'] / 'n2_h*.log'}"],
    "timeline": lambda i: ["timeline", i["phases"]],
    "faults": lambda i: ["faults", i["phases"]],
    "wire": lambda i: ["wire", i["spans"]],
    "codec": lambda i: ["codec", i["spans"]],
    "zero": lambda i: ["zero", i["spans"]],
    "serving": lambda i: ["serving", i["serving"]],
    "flight": lambda i: ["flight", i["flights"][0]],
    "membership": lambda i: ["membership", str(i["dir"] / "flightrec*")],
    "requests": lambda i: ["requests", i["requests"]],
    "stitch": lambda i: ["stitch", str(i["dir"] / "trace.json.p*")],
}


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyze_json_equals_jax(inputs, case, capsys, tmp_path):
    argv = CASES[case](inputs)
    if case == "stitch":
        outs = [tmp_path / "jax.json", tmp_path / "port.json"]
        got = _run(analyze.main, argv + ["--json", "--out", str(outs[1])],
                   capsys)
        want = _run(jax_analyze.main, argv + ["--json", "--out",
                                              str(outs[0])], capsys)
        assert json.loads(got)["flows"] > 0
        assert json.loads(outs[1].read_text()) == \
            json.loads(outs[0].read_text())
        got, want = (json.loads(t) for t in (got, want))
        got.pop("out"), want.pop("out")
        assert got == want
        return
    got = _run(analyze.main, argv + ["--json"], capsys)
    want = _run(jax_analyze.main, argv + ["--json"], capsys)
    assert got.strip() and got == want
    # The markdown too.
    assert _run(analyze.main, argv, capsys) == \
        _run(jax_analyze.main, argv, capsys)


def test_analyze_speedup_rows_equal_jax(inputs):
    runs = {"1": [inputs["logs"]["n1"]],
            "2": [inputs["logs"]["n2_h0"], inputs["logs"]["n2_h1"]]}
    rows = analyze.analyze(runs)
    assert rows == jax_analyze.analyze(runs)
    by = {r["run"]: r for r in rows}
    # Steps 2-4 (the first skipped): normal the slower host's, ideal the
    # faster's, against the one-host run's 1.0 s.
    assert by["2"]["speedup_normal"] == pytest.approx(3 / 1.75, abs=1e-3)
    assert by["2"]["speedup_ideal"] == pytest.approx(3 / 1.45, abs=1e-3)
    assert analyze.to_markdown(rows) == jax_analyze.to_markdown(rows)


# ------------------------------------------------------------------ sweep --

TRAIN_ARGS = ["--network", "LeNet", "--dataset", "synthetic_mnist",
              "--batch-size", "64", "--eval-freq", "0", "--resume", "false"]


def test_sweep_trial_and_best(monkeypatch, capsys):
    r = sweep.run_trial(0.05, probe_step=3, train_argv=TRAIN_ARGS,
                        avg_last=2, device="cpu")
    assert r["steps"] == 3, r.get("error", "")
    assert r["loss"] == r["loss"]   # not NaN
    with pytest.raises(ValueError, match="entries"):
        sweep.run_trial(0.05, 3, TRAIN_ARGS, entry="train.py", device="cpu")

    # The grid and BEST over the same trial results, both packages.
    def fake(lr, probe_step, train_argv, entry="", avg_last=1,
             schedule="constant", extra_env=None, device="cuda"):
        loss = float("nan") if lr == 0.4 else (lr - 0.05) ** 2 + 0.1
        return {"lr": lr, "schedule": schedule, "loss": loss, "acc": 0.5,
                "steps": probe_step}

    outs = []
    for mod, extra in ((sweep, ["--device", "cpu"]), (jax_sweep, [])):
        monkeypatch.setattr(mod, "run_trial", fake)
        outs.append(_run(mod.main, ["--lrs", "0.01,0.05,0.4",
                                    "--schedules", "constant,cosine",
                                    *extra, "--", *TRAIN_ARGS], capsys))
    assert outs[0] == outs[1]
    assert outs[0].splitlines()[-1] == \
        "BEST lr=0.05 schedule=constant loss=0.100000 acc=0.5000"


# ----------------------------------------------------------- scaling_run --

def _scaling_args(**kw):
    import argparse
    return argparse.Namespace(
        network="LeNet", dataset="synthetic_mnist", batch_size=1024,
        steps=12, staleness_limit=8, inject_step_delay=0.25, **kw)


@pytest.mark.parametrize("mode,n", [("sync", 4), ("kofn", 4), ("async", 4),
                                    ("sync", 1), ("async", 1)])
def test_scaling_run_train_argv_is_jax(mode, n):
    got = scaling_run._train_argv(mode, n, _scaling_args(device="cpu"))
    want = jax_scaling_run._train_argv(mode, n, _scaling_args())
    i = got.index("--device")
    assert got[i + 1] == "cpu" and got[:i] + got[i + 2:] == want
    if mode == "kofn":
        assert "3" == got[got.index("--num-aggregate") + 1]
    if mode == "async" and n == 4:
        assert "256" == got[got.index("--batch-size") + 1]
        assert "8" == got[got.index("--staleness-limit") + 1]
        assert "3" == got[got.index("--inject-delay-process") + 1]
    if n == 1:
        assert "--inject-step-delay" not in got


def test_scaling_run_markdown_is_jax(tmp_path):
    result = {
        "network": "LeNet", "dataset": "synthetic_mnist",
        "global_batch": 1024, "steps_per_run": 12,
        "platform": "cpu-simulate", "host_cpus": 8,
        "modes": {"sync": [
            {"run": "1", "steps": 10, "step_time_normal_s": 1.0,
             "step_time_ideal_s": 1.0, "speedup_normal": 1.0,
             "speedup_ideal": 1.0},
            {"run": "2", "steps": 10, "step_time_normal_s": 0.6,
             "step_time_ideal_s": 0.5, "speedup_normal": 1.67,
             "speedup_ideal": 2.0},
        ]},
    }
    md = scaling_run.to_markdown(result)
    assert "cpu-simulate" in md and "## mode = sync" in md
    assert "[1.0, 1.67]" in md and "[1.0, 2.0]" in md
    assert md == jax_scaling_run.to_markdown(result).replace(
        "ps_pytorch_tpu.tools", "ps_pytorch_tpu_torch.tools")
    with pytest.raises(SystemExit):
        scaling_run.main(["--device", "cpu", "--out",
                          str(tmp_path / "SCALING_r04.json")])


# ------------------------------------------------------------ memory_probe --

def test_write_doc_deltas_and_atomicity(tmp_path):
    rows = [
        {"mode": "lm_base", "peak_bytes_in_use": 1000},
        {"mode": "lm_remat", "peak_bytes_in_use": 400},
        {"mode": "cnn_base", "peak_bytes_in_use": None},  # CPU row
        {"mode": "cnn_remat", "peak_bytes_in_use": 300},
    ]
    docs = []
    for mod, name in ((memory_probe, "port.json"),
                      (jax_memory_probe, "jax.json")):
        out = tmp_path / name
        mod._write_doc(str(out), rows)
        doc = json.loads(out.read_text())
        assert doc["deltas"] == {"lm_remat_saves_bytes": 600}
        assert doc["complete"] is False
        mod._write_doc(str(out), rows, final=True)
        docs.append(json.loads(out.read_text()))
        assert not (tmp_path / f"{name}.tmp").exists()
    assert docs[0] == docs[1] and docs[0]["complete"] is True
    assert memory_probe.MODES == jax_memory_probe.MODES
    assert memory_probe.LM_GEOM == jax_memory_probe.LM_GEOM


def test_memory_probe_refuses_before_any_child(tmp_path, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("child spawned")

    monkeypatch.setattr(memory_probe.subprocess, "run", forbidden)
    for argv in (["--modes", "lm_base,lm_typo"],
                 ["--modes", "lm_base", "--out",
                  str(tmp_path / "MEMORY_r04.json")]):
        with pytest.raises(SystemExit):
            memory_probe.main(["--device", "cpu", *argv])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        memory_probe.main(["--modes", "lm_base", "--out",
                           str(tmp_path / "m.json")])


def test_memory_probe_rows_and_timeout(tmp_path, monkeypatch):
    """The artifact after every row (a run cut short still leaves one),
    the rows in the order asked, a child's timeout as a row."""
    out = tmp_path / "m.json"
    seen = []

    def fake_run(cmd, capture_output, text, timeout, **kw):
        mode = cmd[cmd.index("--child") + 1]
        assert cmd[cmd.index("--device") + 1] == "cpu"
        seen.append(len(json.loads(out.read_text())["rows"])
                    if out.exists() else 0)
        if mode == "cnn_base":
            raise subprocess.TimeoutExpired(cmd, timeout)
        row = {"mode": mode, "peak_bytes_in_use": 100}
        return types.SimpleNamespace(returncode=0, stdout=json.dumps(row),
                                     stderr="")

    monkeypatch.setattr(memory_probe.subprocess, "run", fake_run)
    assert memory_probe.main(["--modes", "lm_base,lm_remat,cnn_base",
                              "--device", "cpu", "--timeout", "5",
                              "--out", str(out)]) == 0
    assert seen == [0, 1, 2]
    doc = json.loads(out.read_text())
    assert [r["mode"] for r in doc["rows"]] == ["lm_base", "lm_remat",
                                               "cnn_base"]
    assert doc["rows"][2]["error"] == "timeout 5s"
    assert doc["complete"] is True


SMALL_LM = dict(batch=2, seq_len=32, d_model=64, n_layers=2, n_heads=2,
                vocab=128)


def test_lm_flash_step_matches_jax(monkeypatch):
    """``lm_flash`` at 2 layers and d 64 on the CPU: the port's step from
    the JAX step's initial weights, on the same tokens, gives the JAX
    step's loss within 1e-5 for 3 steps (the JAX flash kernels in
    interpret mode, as its own tests run them)."""
    for mod in (memory_probe, jax_memory_probe):
        monkeypatch.setitem(mod.__dict__, "LM_GEOM", dict(SMALL_LM))
    state, tick = jax_memory_probe._lm_step("lm_flash")
    params = jax.device_get(state.params)
    want = []
    for i in range(3):
        state, metrics = tick(state, i)
        want.append(float(metrics["loss"]))
    port_tick = memory_probe._lm_step("lm_flash", "cpu", params=params)
    got = [float(port_tick(i)["loss"]) for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_child_rows_on_the_cpu(monkeypatch, capsys):
    """A child's row on the CPU: no peak, the JAX note, three step times;
    lm_pp_m2 and lm_base give one loss (one stage, two microbatches)."""
    monkeypatch.setitem(memory_probe.__dict__, "LM_GEOM", dict(SMALL_LM))
    rows = {}
    for mode in ("lm_base", "lm_pp_m1"):
        assert memory_probe.child_main(mode, "cpu") == 0
        rows[mode] = json.loads(capsys.readouterr().out.splitlines()[-1])
    for row in rows.values():
        assert row["peak_bytes_in_use"] is None
        assert row["note"] == "backend reports no memory_stats (CPU)"
        assert len(row["step_s"]) == 3 and row["platform"] == "cpu"
    assert rows["lm_base"]["loss"] == pytest.approx(
        rows["lm_pp_m1"]["loss"], abs=1e-4)


# ------------------------------------------------------------ accuracy_run --

def test_eval_regex_accepts_nan():
    line = "EVAL_LM step 2000 loss nan perplexity nan"
    m = re.search(rf"EVAL_LM step (\d+) loss {accuracy_run._FLOAT} "
                  rf"perplexity {accuracy_run._FLOAT}", line)
    assert m and m.group(3) == "nan"
    assert accuracy_run._FLOAT == jax_accuracy_run._FLOAT


def test_write_source_corpus_is_jax(tmp_path):
    n = accuracy_run.write_source_corpus(str(tmp_path / "c.bin"))
    want = jax_accuracy_run._write_source_corpus(str(REPO),
                                                 str(tmp_path / "j.bin"))
    data = (tmp_path / "c.bin").read_bytes()
    assert n == len(data) == want and n > 100_000
    assert data == (tmp_path / "j.bin").read_bytes()


def test_accuracy_run_contract_parse(tmp_path, monkeypatch):
    """The parent's logic with faked children: the EVAL line becomes the
    artifact, met_target compares Prec@1, the children are the port's
    entries on the asked device."""
    cmds = []

    def fake_child(label, cmd, timeout_s):
        cmds.append(cmd)
        out = ("EVAL step 1200 loss 0.031 prec1 0.9940 prec5 1.0000"
               if label == "evaluate" else "STEP done")
        return types.SimpleNamespace(stdout=out, stderr="", returncode=0)

    monkeypatch.setattr(accuracy_run, "_run_child", fake_child)
    out = tmp_path / "acc.json"
    r = accuracy_run.run(["--out", str(out), "--max-steps", "1200",
                          "--device", "cpu", "--train-dir",
                          str(tmp_path / "td")])
    assert json.loads(out.read_text()) == r
    assert r["prec1"] == 0.994 and r["met_target"] is True
    assert r["platform"] == "cpu" and r["steps"] == 1200
    assert [c[2] for c in cmds] == ["ps_pytorch_tpu_torch.train",
                                    "ps_pytorch_tpu_torch.evaluate"]
    assert all(c[c.index("--device") + 1] == "cpu" for c in cmds)
    recipe = accuracy_run.cnn_recipe(types.SimpleNamespace(
        dataset="Digits", network="LeNet", batch_size=128, lr=0.01,
        max_steps=1200))
    assert cmds[0][3:3 + len(recipe)] == recipe

    def garbage(label, cmd, timeout_s):
        return types.SimpleNamespace(stdout="garbage", stderr="",
                                     returncode=0)

    monkeypatch.setattr(accuracy_run, "_run_child", garbage)
    with pytest.raises(RuntimeError, match="no EVAL line"):
        accuracy_run.run(["--max-steps", "10", "--device", "cpu",
                          "--train-dir", str(tmp_path / "td")])
    with pytest.raises(SystemExit):
        accuracy_run.run(["--device", "cpu", "--out",
                          str(REPO / "ACCURACY_r03.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        accuracy_run.run(["--train-dir", str(tmp_path / "td")])


def test_lm_recipe_is_the_jax_recipe():
    src = Path(jax_accuracy_run.__file__).read_text()
    recipe = accuracy_run.lm_recipe(2000)
    for flag, value in zip(recipe[::2], recipe[1::2]):
        assert f'"{flag}"' in src
        if value != "2000":
            assert re.search(rf'"{re.escape(flag)}",\s*"{value}"', src), flag


# ---------------------------------------------------------- accuracy_codec --

def test_accuracy_codec_runs_and_row(tmp_path, capsys):
    assert accuracy_codec.RUNS == jax_accuracy_codec.RUNS
    row = accuracy_codec.run_one("int8lat_ef", "int8lat", None, True,
                                 steps=2, eval_batches=1, seeds=[42],
                                 device="cpu")
    assert set(row) == {"config", "grad_codec", "topk_frac", "ef", "steps",
                        "seeds", "eval_loss", "eval_loss_std", "prec1",
                        "prec5"}
    assert row["steps"] == 2 and np.isfinite(row["eval_loss"])
    with pytest.raises(SystemExit):
        accuracy_codec.main(["--device", "cpu", "--out",
                             str(tmp_path / "ACCURACY_CODEC_r13.json")])
