"""The port's gradient integrity screen (``ps_pytorch_tpu_torch/resilience/
integrity.py``) against the JAX package's, on the CPU.

- The fault: under the default config (``grad_integrity`` on), the leader
  pool that the port's AsyncTrainer builds and the JAX trainer's
  ``_make_leader_aggregator`` take four contributions, one with a NaN
  leaf; both averages are finite and bitwise equal, and both name the
  same reason.
- The validators, the norms, the MAD gate and the quarantine ledger give
  the JAX package's answers on the same inputs (its
  ``tests/test_integrity.py`` cases, run on both packages).
- ``GradIntegrity`` on both packages over the same scripted rounds: the
  same admitted sets, reasons, events and counters; the bitwise-exclusion
  arc of the drill (a screened-out contributor leaves the aggregate of it
  never having submitted), and a ledger-free control fed the admitted sets
  landing on the same bits.
- Float leaves as tensors screen like the same leaves as numpy.
- ``grad_poison``'s window, the integrity metrics' declarations, and the
  config: accepted across processes, refused elsewhere.
- Clean gradients: the screened AsyncTrainer is bitwise the unscreened.
- Four processes through the launcher, process 2 poisoning its int8lat
  gradients: the leader quarantines it and readmits it.
"""

import io
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.compression.codecs import encode_leaves as jax_encode
from ps_pytorch_tpu.parallel.async_dp import (
    StaleGradientAggregator as JaxAggregator,
)
from ps_pytorch_tpu.resilience import FaultInjector as JaxInjector
from ps_pytorch_tpu.resilience import integrity as jax_integrity
from ps_pytorch_tpu.runtime.async_trainer import AsyncTrainer as JaxTrainer
from ps_pytorch_tpu_torch import config, telemetry
from ps_pytorch_tpu_torch.compression.codecs import encode_leaves
from ps_pytorch_tpu_torch.parallel.async_dp import StaleGradientAggregator
from ps_pytorch_tpu_torch.resilience import FaultInjector, integrity
from ps_pytorch_tpu_torch.runtime.async_trainer import AsyncTrainer
from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

PACKAGES = {"port": integrity, "jax": jax_integrity}


def _several(monkeypatch, **kw) -> config.TrainConfig:
    """A config validated as one process of several (the async trainer
    across processes), without a process group."""
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "4")
    cfg = config.TrainConfig(**kw)
    monkeypatch.delenv("PS_TPU_NUM_PROCESSES")
    return cfg


# ---- the fault: the default leader pool screens a NaN leaf ----

def _contributions(nan_at: int = 2):
    rng = np.random.default_rng(7)
    out = []
    for sid in range(4):
        tree = {"a": rng.standard_normal((6, 3)).astype(np.float32),
                "b": rng.standard_normal(5).astype(np.float32)}
        if sid == nan_at:
            tree["b"][1] = np.nan
        out.append(tree)
    return out


def test_default_leader_pool_screens_a_nan_leaf_like_jax():
    """The leader pool each trainer builds under the default config at
    n = 4: the JAX one drops the NaN contribution with a strike; so must
    the port's (before the screen was ported, it averaged it in)."""
    port = object.__new__(AsyncTrainer)
    port.cfg = config.TrainConfig(mode="async", eval_freq=0)
    port.n, port._wire_homo = 4, False
    port.params = {k: torch.nn.Parameter(torch.zeros(v.shape))
                   for k, v in _contributions()[0].items()}
    port._build_leader()
    jax = object.__new__(JaxTrainer)
    jax.cfg = jax_config.TrainConfig(mode="async", eval_freq=0)
    jax.n, jax._wire_homo, jax._hier = 4, False, False
    jax_agg = jax._make_leader_aggregator()
    for sid, tree in enumerate(_contributions()):
        port.aggregator.submit(sid, 0, {k: torch.as_tensor(v)
                                        for k, v in tree.items()})
        jax_agg.submit(sid, 0, tree)
    avg, info = port.aggregator.collect(0)
    jax_avg, jax_info = jax_agg.collect(0)
    assert info["used"] == jax_info["used"] == [0, 1, 3]
    assert info["rejected"] == jax_info["rejected"] == {
        2: "leaf 1: non-finite gradient values"}
    for k in ("a", "b"):
        got = avg[k].numpy()
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, np.asarray(jax_avg[k]))


# ---- layer 2: validators, norms, the MAD gate (both packages) ----

SPARSE = {"i": np.array([1, 5, 9], np.int32), "v": np.ones(3, np.float32),
          "s": np.array([10], np.int64)}
PAYLOADS = [
    ({"v": np.zeros((3, 4), np.int8), "e": -7}, None),
    ({"v": np.zeros((3, 4), np.int8), "e": -7}, (3, 4)),
    ({"v": np.zeros((3, 4), np.int8), "e": -7}, (4, 3)),
    ({"v": np.zeros(3, np.int8), "e": -32768}, None),
    ({"v": np.zeros(3, np.int8), "e": 99}, None),
    ({"v": np.zeros(3, np.int8), "e": "huge"}, None),
    ({"v": np.zeros(3, np.int16), "e": 0}, None),
    (SPARSE, None), (SPARSE, (10,)), (SPARSE, (11,)),
    (dict(SPARSE, i=np.array([1, 5, 5], np.int32)), None),
    (dict(SPARSE, i=np.array([1, 5, 10], np.int32)), None),
    (dict(SPARSE, i=np.array([-1, 5, 9], np.int32)), None),
    (dict(SPARSE, i=np.array([9, 1, 5], np.int32)), None),
    (dict(SPARSE, v=np.array([1.0, np.nan, 1.0], np.float32)), None),
    (dict(SPARSE, i=np.array([1.0, 5.0, 9.0], np.float32)), None),
    (dict(SPARSE, s=np.array([-2], np.int64)), None),
    ({"i": SPARSE["i"], "v": SPARSE["v"]}, None),
    ({"x": 1}, None), (np.zeros(3), None), ({"v": np.zeros(3)}, None),
]


@pytest.mark.parametrize("payload,shape", PAYLOADS)
def test_validate_payload_like_jax(payload, shape):
    assert integrity.validate_payload(payload, expect_shape=shape) == \
        jax_integrity.validate_payload(payload, expect_shape=shape)


@pytest.mark.parametrize("leaf", [
    np.ones((2, 2), np.float32), np.array([1, 2], np.int32),
    np.array([1.0, np.inf]), np.array([np.nan], np.float32),
    np.float32(0.5)])
def test_validate_float_leaf_like_jax_as_numpy_and_tensor(leaf):
    want = jax_integrity.validate_float_leaf(leaf)
    assert integrity.validate_float_leaf(leaf) == want
    assert integrity.validate_float_leaf(torch.as_tensor(leaf)) == want


def test_payload_and_contribution_norms_like_jax():
    p = {"v": np.array([3, 4], np.int8), "e": 1}
    sp = {"i": np.array([0, 2]), "v": np.array([3.0, 4.0]),
          "s": np.array([5])}
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((33, 7)).astype(np.float32)
    for mod in PACKAGES.values():
        assert mod.payload_norm(p) == pytest.approx(4.0 * 25.0)
        assert mod.payload_norm({"v": np.array([7], np.int8),
                                 "e": -32768}) == 0.0
        assert mod.payload_norm(sp) == pytest.approx(25.0)
        assert mod.contribution_norm([p, sp]) == pytest.approx(
            np.sqrt(125.0))
        # Opaque leaves (bytes, tuples) are skipped, not crashed on.
        assert mod.contribution_norm([b"blosc-frame", ("qt",), sp]) == \
            pytest.approx(5.0)
    want = jax_integrity.contribution_norm([dense, p, np.int32(3)])
    assert integrity.contribution_norm([dense, p, np.int32(3)]) == want
    got = integrity.contribution_norm([torch.as_tensor(dense), p])
    assert got == pytest.approx(want, rel=1e-12)
    assert integrity.payload_norm(torch.as_tensor(dense)) == pytest.approx(
        jax_integrity.payload_norm(dense), rel=1e-12)


@pytest.mark.parametrize("norms", [
    {0: 1.0, 1: 1.1, 2: 0.9, 3: 1.05},
    {0: 1.0, 1: 1.1, 2: 0.9, 3: 1.05, 4: 900.0},
    {0: 1.0, 1: np.nan}, {0: 1.0, 1: 500.0},
    {**{i: 2.5 for i in range(6)}, 9: 2.6},
    {0: 1.0, 1: 1.0, 2: 1.0, 3: np.inf, 4: 1.0}])
def test_mad_outliers_like_jax(norms):
    assert integrity.mad_outliers(norms) == \
        jax_integrity.mad_outliers(norms)


# ---- layer 3: the quarantine ledger ----

def _ledger_script(mod):
    events = []
    q = mod.QuarantineManager(strike_limit=3, readmit_clean=2,
                              on_event=lambda k, c, s, d:
                              events.append((k, c, s, d)))
    out = [q.strike(7, "bad", step=1), q.strike(7, "bad", step=2),
           q.strike(7, "bad", step=3), q.is_quarantined(7),
           q.quarantined_ids(), q.observe_clean(7, step=4),
           q.observe_clean(7, step=5), q.is_quarantined(7),
           q.strike(7, "bad again", step=6)]
    decay = mod.QuarantineManager(strike_limit=3, readmit_clean=2)
    for _ in range(2):
        decay.strike(1, "torn write")
        decay.observe_clean(1)
    decay.strike(1, "torn write")
    return out, events, q.snapshot(), decay.is_quarantined(1)


def test_quarantine_lifecycle_like_jax():
    got, want = _ledger_script(integrity), _ledger_script(jax_integrity)
    assert got == want
    assert [e[0] for e in got[1]] == ["strike", "strike", "strike",
                                      "quarantine", "readmit", "strike",
                                      "quarantine"]
    assert got[2]["integrity_quarantines"] == 2 and not got[3]
    for mod in PACKAGES.values():
        with pytest.raises(ValueError):
            mod.QuarantineManager(strike_limit=0)
        with pytest.raises(ValueError):
            mod.GradIntegrity(mad_threshold=0)


def _screen_rounds(mod, encode):
    """The JAX test's screen of real int8lat payloads: contributor 2 at
    1000x is an outlier twice (quarantined at strike_limit 2), then a
    clean round readmits it."""
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=(8, 4)).astype(np.float32),
              rng.normal(size=(16,)).astype(np.float32)]
    poisoned = [(sid, encode("int8lat", [l * (1000.0 if sid == 2 else 1.0)
                                         for l in leaves],
                             slice_id=sid, step=0)) for sid in range(4)]
    clean = [(sid, encode("int8lat", leaves, slice_id=sid, step=3))
             for sid in range(4)]
    events = []
    gi = mod.GradIntegrity(mad_threshold=6.0, strike_limit=2,
                           readmit_clean=1,
                           on_event=lambda *e: events.append(e))
    rounds = [gi.screen(poisoned, step=1), gi.screen(poisoned, step=2),
              gi.screen(clean, step=3)]
    return rounds, events, gi.snapshot()


def test_grad_integrity_screen_real_payloads_like_jax():
    got = _screen_rounds(integrity, encode_leaves)
    assert got == _screen_rounds(jax_integrity, jax_encode)
    rounds, _, snap = got
    assert rounds[0][0] == [0, 1, 3] and "outlier" in rounds[0][1][2]
    assert rounds[2] == ([0, 1, 2, 3], {})
    assert snap["integrity_outlier_rejects"] == 2
    assert snap["integrity_quarantines"] == 1
    assert snap["integrity_readmissions"] == 1


def _bitwise_arc(agg_cls, gi_cls, encode, total_steps=24):
    """The poison drill's in-process arc: contributor 3 sends 1e8-scaled
    payloads for steps 4-9 (validators pass; the MAD gate must catch
    them), is quarantined at the third strike and readmitted after three
    clean screens; a ledger-free control fed exactly the admitted sets
    lands on the same bits."""
    n, size, lr = 4, 257, 0.05
    events = []
    gi = gi_cls(mad_threshold=6.0, strike_limit=3, readmit_clean=3,
                on_event=lambda k, c, s, d: events.append((k, c, s, d)))

    def agg(ledger):
        return agg_cls(n, staleness_limit=4, num_aggregate=0, compress=True,
                       codec="int8lat", integrity=ledger)

    def wire(i, t, scale=1.0):
        g = np.random.default_rng(500 + 31 * i + t).standard_normal(
            size).astype(np.float32) * scale
        return {"g": encode("int8lat", [g], slice_id=i, step=t)[0]}

    screened, control = agg(gi), agg(None)
    p = np.random.default_rng(0).standard_normal(size).astype(np.float32)
    p_ctl = p.copy()
    used, reasons = [], []
    for t in range(total_steps):
        for i in range(n):
            scale = 1e8 if (i == 3 and 4 <= t < 10) else 1.0
            screened.submit_encoded(i, t, wire(i, t, scale))
        avg, info = screened.collect(t)
        for i in info["used"]:
            control.submit_encoded(i, t, wire(i, t))
        avg_ctl, info_ctl = control.collect(t)
        assert info_ctl["used"] == info["used"]
        assert "rejected" not in info_ctl
        p = (p - lr * np.asarray(avg["g"], np.float32)).astype(np.float32)
        p_ctl = (p_ctl - lr * np.asarray(avg_ctl["g"], np.float32)).astype(
            np.float32)
        used.append(info["used"])
        reasons.append(info["rejected"])
        for a, inf in ((screened, info), (control, info_ctl)):
            a.consume(inf["used"])
            a.drop_older_than(t)
    return p, p_ctl, used, reasons, events, gi.snapshot()


def test_bitwise_exclusion_arc_like_jax():
    got = _bitwise_arc(StaleGradientAggregator, integrity.GradIntegrity,
                       encode_leaves)
    want = _bitwise_arc(JaxAggregator, jax_integrity.GradIntegrity,
                        jax_encode)
    p, p_ctl, used, reasons, events, snap = got
    np.testing.assert_array_equal(p, p_ctl)
    np.testing.assert_array_equal(p, want[0])
    assert (used, reasons, events, snap) == want[2:]
    kinds = [e[0] for e in events]
    assert kinds.index("quarantine") < kinds.index("readmit")
    assert snap["integrity_outlier_rejects"] >= 3
    assert snap["integrity_quarantined"] == 0


def test_tensor_contributions_screen_like_numpy():
    """A pool of float tensors (the port's device pools) and the same
    leaves as numpy: the same admitted ids, reasons, events and norms."""
    rng = np.random.default_rng(11)
    base = [rng.standard_normal((40, 9)).astype(np.float32),
            np.arange(6, dtype=np.int32),
            rng.standard_normal(17).astype(np.float32)]

    def rounds():
        out = []
        for t in range(6):
            contrib = []
            for sid in range(5):
                leaves = [l.copy() for l in base]
                leaves[0] *= 1.0 + 0.01 * sid + 0.001 * t
                if sid == 1 and t == 0:
                    leaves[2][3] = np.nan
                if sid == 4 and 1 <= t <= 4:
                    leaves[0] *= 1e8
                contrib.append((sid, leaves))
            out.append(contrib)
        return out

    def run(as_tensor):
        events = []
        gi = integrity.GradIntegrity(on_event=lambda *e: events.append(e))
        verdicts = [gi.screen([(sid, [torch.as_tensor(l) for l in leaves]
                                if as_tensor else leaves)
                               for sid, leaves in contrib], step=t)
                    for t, contrib in enumerate(rounds())]
        return verdicts, events, gi.snapshot()

    got, want = run(True), run(False)
    assert got == want
    jax_gi = jax_integrity.GradIntegrity()
    assert [jax_gi.screen(c, step=t) for t, c in enumerate(rounds())] == \
        want[0]
    assert want[2]["integrity_quarantines"] == 1
    assert "leaf 2: non-finite" in want[0][0][1][1]


# ---- the fault plane, the metrics, the config ----

def test_poison_scale_window_like_jax():
    spec = "grad_poison:scale=1000,r=2,step=3,steps=8"
    for pid in (1, 2):
        ours, theirs = FaultInjector(spec, pid), JaxInjector(spec, pid)
        assert [ours.poison_scale(s) for s in range(20)] == \
            [theirs.poison_scale(s) for s in range(20)]
        assert ours.counters["grad_poisons"] == \
            theirs.counters["grad_poisons"] == (8 if pid == 2 else 0)
    forever = FaultInjector("grad_poison:scale=-9", process_index=0)
    assert forever.poison_scale(10 ** 6) == -9.0


def test_integrity_metrics_declared_like_jax():
    from ps_pytorch_tpu.telemetry import registry as jax_registry
    from ps_pytorch_tpu_torch.telemetry.prometheus import render
    assert telemetry.INTEGRITY_COUNTERS == jax_registry.INTEGRITY_COUNTERS
    assert telemetry.INTEGRITY_GAUGES == jax_registry.INTEGRITY_GAUGES
    r = telemetry.declare_integrity_metrics(telemetry.Registry())
    r.inc("integrity_quarantines")
    r.set("integrity_quarantined", 1.0)
    text = render(r)
    assert "integrity_quarantines_total 1" in text
    assert "integrity_quarantined 1" in text


@pytest.mark.parametrize("kw", [
    dict(integrity_mad_threshold=0.0), dict(integrity_strike_limit=0),
    dict(integrity_readmit_clean=0)])
def test_integrity_bounds_refused_like_jax(kw, monkeypatch):
    msgs = []
    for mod in (config, jax_config):
        monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "2")
        with pytest.raises(ValueError) as e:
            mod.TrainConfig(mode="async", eval_freq=0, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_integrity_fields_run_across_processes_only(monkeypatch):
    kw = dict(mode="async", eval_freq=0, grad_integrity=False,
              integrity_mad_threshold=4.0, integrity_strike_limit=2,
              integrity_readmit_clean=5, metrics_port=9300,
              fault_spec="grad_poison:scale=1e38,r=2,step=3,steps=16")
    cfg = _several(monkeypatch, **kw)
    assert (cfg.grad_integrity, cfg.integrity_strike_limit) == (False, 2)
    for name in ("grad_integrity", "metrics_port", "fault_spec"):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            config.TrainConfig(mode="async", eval_freq=0,
                               **{name: kw[name]})
    for mode in ("sync", "kofn"):
        with pytest.raises(ValueError, match="grad_poison.*ROADMAP.md"):
            config.TrainConfig(mode=mode, eval_freq=0,
                               fault_spec=kw["fault_spec"])
        with pytest.raises(ValueError, match="async across processes"):
            config.TrainConfig(mode=mode, eval_freq=0,
                               integrity_strike_limit=2)


# ---- the screen on clean gradients changes nothing ----

def test_screened_trainer_is_bitwise_the_unscreened(tmp_path, monkeypatch):
    params = []
    for on in (True, False):
        cfg = _several(monkeypatch, dataset="synthetic_mnist",
                       network="LeNet", batch_size=64, lr=0.05,
                       momentum=0.9, compute_dtype="float32", mode="async",
                       max_steps=3, eval_freq=0, resume=False,
                       train_dir=str(tmp_path / str(on)),
                       grad_integrity=on)
        t = AsyncTrainer(cfg, kv=KVStore(), device="cpu",
                         printer=lambda line: None)
        with redirect_stdout(io.StringIO()) as out:
            t.train()
        assert t.version == t.applied == 3
        assert (t._integrity is not None) == on
        assert ("INTEGRITY pid 0 screen_rejects 0 outlier_rejects 0 "
                "strikes 0" in out.getvalue()) == on
        params.append({k: v.detach().clone() for k, v in t.params.items()})
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k


# ---- four processes: process 2 poisons its gradients ----

def test_four_processes_quarantine_and_readmit_a_poisoner(tmp_path,
                                                          monkeypatch):
    """The JAX drill's poison leg on LeNet: process 2 scales its own
    gradients by 1e38 for 16 of its steps (int8lat, EF off) while 1% of
    the leader's gradient chunk reads are bit-flipped. Process 0's log
    shows the quarantine and the readmission of contributor 2, its
    summary the screen rejects and a caught digest failure; every
    process ends with a finite loss."""
    run_dir = tmp_path / "run"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            rc = launch.main([
                "launch", "--run-dir", str(run_dir), "--simulate", "4",
                "--port", str(free_port()), "--wait", "--timeout", "240",
                "--", "--device", "cpu", "--mode", "async", "--network",
                "LeNet", "--dataset", "synthetic_mnist", "--batch-size",
                "64", "--compute-dtype", "float32", "--lr", "0.05",
                "--momentum", "0.9", "--max-steps", "40", "--eval-freq",
                "0", "--log-every", "4", "--staleness-limit", "4",
                "--resume", "false", "--train-dir", str(tmp_path / "td"),
                "--compress-grad", "true", "--grad-codec", "int8lat",
                "--kv-retry-attempts", "2", "--fault-spec",
                "grad_poison:scale=1e38,r=2,step=3,steps=16;"
                "payload_bitflip:p=0.01,seed=11,prefix=async-42/agrad"])
    finally:
        launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
    logs = [Path(run_dir, f"proc_{r}.log").read_text() for r in range(4)]
    detail = out.getvalue() + "\n\n".join(log[-2000:] for log in logs)
    assert rc == 0, detail
    assert re.search(r"^INTEGRITY quarantine contributor 2 at version \d+ "
                     r"\(leaf \d+: ", logs[0], re.M), detail
    assert re.search(r"^INTEGRITY readmit contributor 2 at version \d+$",
                     logs[0], re.M), detail
    m = re.search(r"^INTEGRITY pid 0 screen_rejects (\d+) outlier_rejects "
                  r"\d+ strikes \d+ quarantines (\d+) readmissions (\d+) "
                  r"wire_failures (\d+)$", logs[0], re.M)
    assert m, detail
    rejects, quarantines, readmissions, digests = map(int, m.groups())
    assert rejects >= 3 and quarantines >= 1 and readmissions >= 1, detail
    assert digests >= 1, detail
    assert not any("INTEGRITY pid" in log for log in logs[1:]), detail
    finals = [re.findall(r"^FINAL loss (\S+) ", log, re.M) for log in logs]
    assert all(len(f) == 1 and np.isfinite(float(f[0])) for f in finals), \
        detail
