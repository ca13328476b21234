"""``--sync-topology hier`` in the port's trainers against the JAX
package's, on the CPU.

- The config admits the five hierarchy fields under ``--mode async`` and
  refuses what the JAX config refuses, with its messages; under
  ``--mode sync|kofn`` they stay refused (the JAX sync trainers ignore
  them), and ``--leader-lease-s`` is admitted across processes without
  ``--elastic`` under hier, as the group lease's interval.
- ``MultiSliceTrainer`` (LeNet, 4 slices in 2 groups, int8lat) against the
  JAX trainer from the same weights: the canonical parameters after 4
  ticks within the rounding the hops allow (one int8lat lattice step a
  hop of each tick's gradient, carried through the momentum).
- The checkpoint carries ``"ef"`` under hier with or without ``--ef``, as
  ``{"members": {slice: {i: r}}, "g<gid>": {i: r}}`` in the JAX layouts,
  and each package resumes the other's.
- Four LeNet processes through the launcher on ``--sync-topology hier``
  finish with equal FINAL lines.
"""

import re

import jax
import numpy as np
import pytest
from flax import serialization

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.parallel import hierarchy as jax_hier
from ps_pytorch_tpu.runtime import multislice as jax_multislice
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.parallel.hierarchy import HierarchicalAggregator
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.multislice import MultiSliceTrainer
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

HIER = dict(compress_grad=True, grad_codec="int8lat", sync_topology="hier",
            sync_group_size=2)


def _kw(**over):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.05, momentum=0.9, compute_dtype="float32", mode="async",
                max_steps=4, eval_freq=0, log_every=100)
    base.update(over)
    return base


# ---- the config ----

@pytest.mark.parametrize("kw", [
    dict(sync_topology="hier"),
    dict(sync_topology="hier", compress_grad=True, grad_codec="blosc"),
    dict(mode="async", sync_topology="hier", compress_grad=True,
         grad_codec="int8"),
    dict(sync_topology="ring"), dict(sync_intra_every=0),
    dict(sync_inter_every=0), dict(hier_hop_retries=0),
    dict(sync_group_size=-1),
    dict(mode="async", shard_wire=True, **HIER),
])
def test_config_hier_requires_homomorphic_codec(kw):
    """What the JAX config refuses, refused with its message."""
    msgs = []
    for cls in (config.TrainConfig, jax_config.TrainConfig):
        with pytest.raises(ValueError) as e:
            cls(eval_freq=0, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if "sync_topology" in kw and kw.get("grad_codec") != "int8lat":
        assert "sync_topology" in msgs[0]


@pytest.mark.parametrize("kw", [
    dict(HIER), dict(HIER, grad_codec="topk", ef=True, sync_group_size=0),
    dict(HIER, grad_codec="randk", sync_intra_every=2, sync_inter_every=3,
         hier_hop_retries=1, num_aggregate=2)])
def test_config_admits_hier_under_async(kw, monkeypatch):
    for processes in ("1", "4"):
        monkeypatch.setenv("PS_TPU_NUM_PROCESSES", processes)
        cfg = config.TrainConfig(**_kw(**kw))
        assert {k: getattr(cfg, k) for k in kw} == kw
        assert config.TrainConfig.from_json(
            jax_config.TrainConfig(**_kw(**kw)).to_json()) == cfg


@pytest.mark.parametrize("mode", ["sync", "kofn"])
@pytest.mark.parametrize("field,value", [
    ("sync_topology", "hier"), ("sync_group_size", 2),
    ("sync_intra_every", 2), ("sync_inter_every", 2),
    ("hier_hop_retries", 1)])
def test_config_still_refuses_hier_in_sync_modes(mode, field, value):
    kw = {"eval_freq": 0, "mode": mode, field: value}
    if mode == "kofn":
        kw["num_aggregate"] = 1
    if field == "sync_topology":
        kw.update(compress_grad=True, grad_codec="int8lat")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        config.TrainConfig(**kw)


def test_config_leader_lease_sets_the_group_lease_under_hier(monkeypatch):
    """Trap: the JAX drill runs hier with a 3 s lease and no --elastic.
    Across processes the port admits it under hier (not flat); in one
    process no trainer reads it."""
    kw = _kw(leader_lease_s=3.0, **HIER)
    with pytest.raises(ValueError, match="leader_lease_s.*ROADMAP.md"):
        config.TrainConfig(**kw)
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "4")
    assert config.TrainConfig(**kw).leader_lease_s == 3.0
    with pytest.raises(ValueError, match="--sync-topology hier"):
        config.TrainConfig(**_kw(leader_lease_s=3.0))
    assert jax_config.TrainConfig(**kw).elastic is False


# ---- MultiSliceTrainer ----

def _pair(tmp_path, n=4, **over):
    kw = _kw(train_dir=str(tmp_path / "none"), **dict(HIER, **over))
    jt = jax_multislice.MultiSliceTrainer(
        jax_config.TrainConfig(**kw), n_slices=n,
        devices=jax.devices()[:n])
    pt = MultiSliceTrainer(config.TrainConfig(**kw), n_slices=n,
                           device="cpu", printer=lambda line: None)
    pt.load_jax(serialization.to_state_dict(
        jax.device_get(jt._as_train_state())),
        [jax.device_get(bs) for bs in jt._bs])
    return jt, pt


def test_multislice_hier_ticks_match_jax_within_hop_rounding(tmp_path):
    """4 ticks of 4 slices in 2 groups from the same weights, with --ef:
    the same used lists, and each tick's applied average within one
    int8lat lattice step a hop of the JAX trainer's (two hops: the
    member's encode and the group's re-encode; a leaf's step is at most
    2^-6 of the largest member gradient), as the two packages' f32
    gradients differ in the last bits and a rounding may fall the other
    way. The parameters after 4 ticks within those differences carried
    through the momentum. Then both checkpoint, and each package resumes
    the other's EF (``_assert_ef_crosses``)."""
    jt, pt = _pair(tmp_path, ef=True, eval_freq=4)
    assert isinstance(pt.aggregator, HierarchicalAggregator)
    assert isinstance(jt.aggregator, jax_hier.HierarchicalAggregator)
    names = sorted(pt.params)
    seen = {"port": [], "jax": [], "absmax": []}

    def record(agg, key):
        collect, submit = agg.collect, agg.submit

        def collect_(step):
            avg, info = collect(step)
            seen[key].append(avg)
            return avg, info

        def submit_(sid, step, grads):
            if key == "port":
                if sid == 0:
                    seen["absmax"].append({})
                top = seen["absmax"][-1]
                for n in names:
                    top[n] = max(top.get(n, 0.0),
                                 float(grads[n].abs().max()))
            submit(sid, step, grads)

        agg.collect, agg.submit = collect_, submit_

    record(pt.aggregator, "port")
    record(jt.aggregator, "jax")
    for _ in range(4):
        ji, pi = jt.tick(), pt.tick()
        assert pi["computed"] == ji["computed"] == [0, 1, 2, 3]
        assert pi["used"] == ji["used"] == [0, 1, 2, 3]
    assert (pt.applied, jt.applied) == (4, 4)
    lr, mom, hops = 0.05, 0.9, 2
    bound = {n: 0.0 for n in names}
    for t in range(4):
        want = jax.tree_util.tree_leaves(seen["jax"][t])
        for n, w in zip(names, want):
            step = 2.0 ** -6 * seen["absmax"][t][n]
            got = convert.leaf_layout(n, np.asarray(seen["port"][t][n]),
                                      True)
            assert np.max(np.abs(got - np.asarray(w))) <= hops * step, \
                (t, n)
            # The momentum carries tick t's difference into the 4 - t
            # updates from t on.
            bound[n] += lr * hops * step * sum(mom ** k
                                               for k in range(4 - t))
    got = convert.to_jax(pt.model.state_dict())[0]
    want = jax.device_get(jt.params)
    for n in names:
        path = convert.jax_path(n, pt.params[n].dim())
        a, b = np.asarray(got[path[0]][path[1]]), np.asarray(
            want[path[0]][path[1]])
        assert np.max(np.abs(a - b)) <= bound[n] + 1e-6, n
    _assert_ef_crosses(tmp_path, jt, pt, n=4, ef=True, step=4)


def test_multislice_hier_topology_trains_and_checkpoints(tmp_path):
    """The JAX test of the same name: ticks apply updates from all slices
    and the hop EF rides the checkpoint (``"ef"`` without ``--ef``)."""
    cfg = config.TrainConfig(**_kw(
        eval_freq=2, train_dir=str(tmp_path / "ckpt"),
        **dict(HIER, sync_group_size=1)))
    t = MultiSliceTrainer(cfg, n_slices=2, device="cpu",
                          printer=lambda line: None)
    assert isinstance(t.aggregator, HierarchicalAggregator)
    info = t.tick()
    assert sorted(info["used"]) == [0, 1]
    t.train()
    assert t.applied == 4
    step = ckpt.latest_valid_step(cfg.train_dir)
    extra = ckpt.load_extra_state(cfg.train_dir, step)
    assert extra is not None and "ef" in extra
    assert sorted(extra["ef"]) == ["g0", "g1", "members"]
    t2 = MultiSliceTrainer(cfg, n_slices=2, device="cpu",
                           printer=lambda line: None)
    assert t2.maybe_resume() and t2.step == 4


def test_multislice_hier_accepts_flat_num_aggregate(tmp_path):
    cfg = config.TrainConfig(**_kw(
        batch_size=8, max_steps=1, train_dir=str(tmp_path / "ckpt"),
        num_aggregate=4, **dict(HIER, sync_group_size=0)))
    t = MultiSliceTrainer(cfg, n_slices=8, device="cpu",
                          printer=lambda line: None)
    assert t.aggregator.root.k == t.aggregator.plan.n_groups == 3


def _ef_leaves(ef):
    """(tier, slice or None, leaf index) -> residual of a hier EF dict."""
    out = {}
    for tier, d in ef.items():
        if tier == "members":
            for sid, leaves in d.items():
                out.update({(tier, sid, i): r for i, r in leaves.items()})
        else:
            out.update({(tier, None, i): r for i, r in d.items()})
    return out


def _assert_ef_crosses(tmp_path, jt, pt, n, ef, step):
    """Both trainers checkpoint at ``step``: ``"ef"`` holds the members'
    tier (empty without --ef) and each group's hop residuals, the port's
    in the JAX layouts (the JAX trainer's shapes, values within a lattice
    step), and each package resumes the other's, the port's residuals
    being the JAX ones laid out back bitwise."""
    jt.cfg = jt.cfg.replace(train_dir=str(tmp_path / "jax"))
    pt.cfg.train_dir = str(tmp_path / "port")
    jt._checkpoint(), pt._checkpoint()
    ef_p = ckpt.load_extra_state(str(tmp_path / "port"), step)["ef"]
    ef_j = ckpt.load_extra_state(str(tmp_path / "jax"), step)["ef"]
    groups = [f"g{g}" for g in range(pt.aggregator.plan.n_groups)]
    assert sorted(ef_p) == sorted(ef_j) == groups + ["members"]
    assert sorted(ef_p["members"]) == sorted(ef_j["members"]) == \
        ([str(s) for s in range(n)] if ef else [])
    lp, lj = _ef_leaves(ef_p), _ef_leaves(ef_j)
    assert sorted(lp) == sorted(lj) and lp
    for k, r in lj.items():
        assert lp[k].shape == r.shape, k
        np.testing.assert_allclose(lp[k], r, atol=2e-3, err_msg=str(k))
    kw = jax_config.TrainConfig.to_json(jt.cfg)
    j2 = jax_multislice.MultiSliceTrainer(
        jax_config.TrainConfig.from_json(kw).replace(
            train_dir=str(tmp_path / "port")),
        n_slices=n, devices=jax.devices()[:n])
    assert j2.maybe_resume() and j2.step == step
    jgot = _ef_leaves(j2.aggregator.ef_state_dict())
    for k, r in lp.items():
        assert np.asarray(jgot[k]).tobytes() == r.tobytes(), k
    cfg = config.TrainConfig.from_json(kw)
    cfg.train_dir = str(tmp_path / "jax")
    p2 = MultiSliceTrainer(cfg, n_slices=n, device="cpu",
                           printer=lambda line: None)
    assert p2.maybe_resume() and p2.step == step
    names = sorted(p2.params)
    got = _ef_leaves(p2.aggregator.ef_state_dict())
    for (tier, sid, i), r in lj.items():
        want = convert.leaf_layout(names[int(i)], r, to_jax=False)
        mine = got[(tier, sid, i)]
        assert mine.shape == tuple(p2.params[names[int(i)]].shape)
        assert mine.tobytes() == np.ascontiguousarray(want).tobytes()
    j2.tick(), p2.tick()                # the loaded residuals fit the grads


def test_hier_ef_checkpoint_crosses_packages_without_ef(tmp_path):
    """Trap: the hop EF is on without --ef, so ``"ef"`` rides a hier
    checkpoint regardless (2 slices in groups of one, one tick)."""
    jt, pt = _pair(tmp_path, n=2, eval_freq=1, max_steps=1,
                   sync_group_size=1)
    jt.tick(), pt.tick()
    _assert_ef_crosses(tmp_path, jt, pt, n=2, ef=False, step=1)


def test_flat_ef_checkpoint_resumes_under_hier(tmp_path):
    """A flat run's ``{slice: {i: r}}`` residuals go to the member tier of
    a hier run resumed from its checkpoint."""
    flat = _kw(eval_freq=1, max_steps=1, compress_grad=True,
               grad_codec="int8lat", ef=True, train_dir=str(tmp_path))
    t = MultiSliceTrainer(config.TrainConfig(**flat), n_slices=2,
                          device="cpu", printer=lambda line: None)
    t.train()
    saved = t.aggregator.ef_state_dict()
    h = MultiSliceTrainer(config.TrainConfig(**dict(flat, **HIER,
                                                    max_steps=2)),
                          n_slices=2, device="cpu",
                          printer=lambda line: None)
    assert h.maybe_resume() and h.step == 1
    members = h.aggregator.ef_state_dict()["members"]
    assert sorted(members) == sorted(saved) == ["0", "1"]
    for sid in saved:
        for i, r in saved[sid].items():
            assert members[sid][i].tobytes() == r.tobytes()


# ---- across processes ----

def test_four_processes_on_hier_agree(tmp_path):
    """Four LeNet processes in two groups of two through the launcher, no
    fault: the topology lines, group 0's aggregates published by process
    0 alone, the root's summary and four equal FINAL lines."""
    run_dir = tmp_path / "run"
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")       # ranks share the test's cores
    try:
        rc = launch.main([
            "launch", "--run-dir", str(run_dir), "--simulate", "4",
            "--port", str(free_port()), "--wait", "--timeout", "150",
            "--grace", "1", "--", "--device", "cpu", "--mode", "async",
            "--network", "LeNet", "--dataset", "synthetic_mnist",
            "--batch-size", "32", "--compute-dtype", "float32",
            "--fused-optimizer", "--lr", "0.05", "--momentum", "0.9",
            "--compress-grad", "--grad-codec", "int8lat", "--ef",
            "--sync-topology", "hier", "--sync-group-size", "2",
            "--leader-lease-s", "3", "--max-steps", "6", "--eval-freq", "3",
            "--test-batch-size", "2000", "--resume", "false", "--train-dir",
            str(tmp_path / "td"), "--metrics-file",
            str(tmp_path / "m.jsonl")])
    finally:
        mp.undo()
        launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
    logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(4)]
    assert rc == 0, "\n\n".join(log[-3000:] for log in logs)
    finals = [re.findall(r"^FINAL .*$", log, re.M) for log in logs]
    assert len(finals[0]) == 1 and all(f == finals[0] for f in finals)
    for pid, log in enumerate(logs):
        assert f"HIER topology pid {pid}: {{'n_slices': 4, 'group_size': " \
               f"2, 'n_groups': 2, 'aggregators': [0, 2]" in log
        m = re.search(r"^HIERARCHY pid (\d) gid (\d) aggregator (\d) hops "
                      r"(\d+) publishes (\d+)", log, re.M)
        assert m and int(m.group(1)) == pid and int(m.group(2)) == pid // 2
        if pid < 2:
            # Process 0 holds group 0's lease and pumps every tick; group
            # 1 may join after the leader's last version (the leader
            # waits for no follower), so its publishes are not counted.
            assert (int(m.group(5)) > 0) == (pid == 0), log[-2000:]
    assert re.search(r"^HIERARCHY pid 0 .* groups_healthy \d$", logs[0],
                     re.M)
    assert ckpt.committed_steps(str(tmp_path / "td")) == [3, 6]
    rows = [line for line in (tmp_path / "m.jsonl").read_text()
            .splitlines() if line]
    assert rows and '"hier_group_publishes"' in rows[-1]
