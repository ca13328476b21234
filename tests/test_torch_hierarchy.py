"""The port's hierarchical multi-hop sync (``parallel/hierarchy.py``)
against the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_hierarchy.py`` (but the
regress family's two) runs here on the port's module; where the JAX module
takes the same inputs cheaply, the two run side by side on the same seeded
numpy trees and their outputs are held BITWISE: the plan, the group hop's
re-encoded payloads, the root's averages and ``info``, the events and
counters of a partition arc, ``ef_state_dict()``, and the drill's bitwise
phase (RESILIENCE_r14.json's events and counters, and the final vector of
the JAX package's aggregator). The transport runs on a ManualClock over an
in-memory KV, and on a FileKV directory against the JAX transport: each
package's root reads the other's group publish, and the keys are the same
bytes.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from ps_pytorch_tpu import resilience as jax_res
from ps_pytorch_tpu.compression import codecs as jax_codecs
from ps_pytorch_tpu.parallel import async_dp as jax_async_dp
from ps_pytorch_tpu.parallel import hierarchy as jax_hier
from ps_pytorch_tpu.runtime.coordinator import FileKV as JaxFileKV
from ps_pytorch_tpu.runtime.coordinator import KVStore as JaxKVStore
from ps_pytorch_tpu.tools import hierarchy_drill as jax_drill
from ps_pytorch_tpu_torch.compression.codecs import (
    encode_leaves, get_grad_codec, is_payload,
)
from ps_pytorch_tpu_torch.parallel import hierarchy as hier
from ps_pytorch_tpu_torch.parallel.async_dp import (
    StaleGradientAggregator, tree_flatten, tree_unflatten,
)
from ps_pytorch_tpu_torch.parallel.hierarchy import (
    GroupAggregator, HierarchicalAggregator, HierarchicalKVTransport,
    HierarchyPlan, RootAggregator,
)
from ps_pytorch_tpu_torch.resilience import (
    FaultInjector, ManualClock, TransientKVError, parse_fault_spec,
)
from ps_pytorch_tpu_torch.runtime.coordinator import FileKV, KVStore
from ps_pytorch_tpu_torch.tools import hierarchy_drill
from test_torch_train import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grads(seed, size=32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(size).astype(np.float32),
            "b": rng.standard_normal(size // 4).astype(np.float32)}


def _encode(grads, slice_id, step, codec="int8lat"):
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, encode_leaves(
        codec, leaves, slice_id=slice_id, step=step))


def _jax_encode(grads, slice_id, step, codec="int8lat"):
    leaves, treedef = jax.tree.flatten(grads)
    return jax.tree.unflatten(treedef, jax_codecs.encode_leaves(
        codec, leaves, slice_id=slice_id, step=step))


# The two packages behind one surface: a test body written once runs on
# each, and the results are held bitwise.
PKG = {
    "port": SimpleNamespace(hier=hier, SGA=StaleGradientAggregator,
                            encode=_encode, KV=KVStore,
                            FaultInjector=FaultInjector,
                            ManualClock=ManualClock),
    "jax": SimpleNamespace(hier=jax_hier,
                           SGA=jax_async_dp.StaleGradientAggregator,
                           encode=_jax_encode, KV=JaxKVStore,
                           FaultInjector=jax_res.FaultInjector,
                           ManualClock=jax_res.ManualClock),
}


def _decode_payload_tree(tree, codec="int8lat"):
    """One payload decoded through the homomorphic sum's surface."""
    c = get_grad_codec(codec)
    leaves, treedef = tree_flatten(tree, is_leaf=is_payload)
    out = []
    for p in leaves:
        st = c.sum_init()
        c.sum_add(st, p, 1.0)
        out.append(c.sum_finish(st, 1.0, c.payload_shape(p)))
    return tree_unflatten(treedef, out)


def _flat(tree, pre=()):
    """path -> numpy array of every array in a nested dict (payload dicts
    walked into), sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_flat(tree[k], pre + (str(k),)))
        return out
    return {pre: np.asarray(tree)}


def assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def _leaves(tree):
    return [np.asarray(x) for x in tree_flatten(tree)[0]]


def _both(body):
    """``body(pkg)`` on each package -> (port's result, JAX's result)."""
    return body(PKG["port"]), body(PKG["jax"])


# ---- topology plan ----

def test_plan_contiguous_groups_and_preferred_aggregator():
    plan = HierarchyPlan(9, group_size=3)
    assert plan.n_groups == 3
    assert plan.members(1) == [3, 4, 5]
    assert plan.group_of(5) == 1
    assert [plan.aggregator_of(g) for g in range(3)] == [0, 3, 6]
    assert plan.describe() == {"n_slices": 9, "group_size": 3,
                               "n_groups": 3, "aggregators": [0, 3, 6]}


@pytest.mark.parametrize("n,gsize", [(9, 0), (7, 3), (3, 8), (4, 2),
                                     (27, 3), (1, 0), (10, 0)])
def test_plan_auto_group_size_is_sqrt_and_ragged_tail(n, gsize):
    """The auto size (~sqrt n), a ragged last group, a size above n, and
    every plan field and tier equal to the JAX plan's."""
    plan, want = HierarchyPlan(n, gsize), jax_hier.HierarchyPlan(n, gsize)
    assert (plan.group_size, plan.n_groups) == (want.group_size,
                                                want.n_groups)
    assert plan.describe() == want.describe()
    assert [plan.members(g) for g in range(plan.n_groups)] == \
        [want.members(g) for g in range(want.n_groups)]
    assert plan.levels() == want.levels()
    if (n, gsize) == (9, 0):
        assert plan.group_size == 3
    if (n, gsize) == (7, 3):
        assert plan.n_groups == 3 and plan.members(2) == [6]
    if (n, gsize) == (3, 8):
        assert plan.n_groups == 1


def test_plan_levels_extensible_to_n_tiers():
    assert HierarchyPlan(9, group_size=3).levels() == [
        [[0, 1, 2], [3, 4, 5], [6, 7, 8]], [[0, 1, 2]]]
    lv = HierarchyPlan(27, group_size=3).levels()
    assert [len(t) for t in lv] == [9, 3, 1]


@pytest.mark.parametrize("bad", [
    lambda m: m.HierarchyPlan(0), lambda m: m.HierarchyPlan(4, -1),
    lambda m: m.HierarchyPlan(4).group_of(4),
    lambda m: m.HierarchyPlan(4, group_size=2).members(2)])
def test_plan_validation(bad):
    msgs = []
    for mod in (hier, jax_hier):
        with pytest.raises(ValueError) as e:
            bad(mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- tier 1: the group hop ----

def test_group_hop_identical_members_is_lattice_exact():
    """Members with the SAME gradient: their average lies on the lattice,
    so the re-encode is lossless; the hop payloads equal the JAX hop's."""
    def body(m):
        plan = m.hier.HierarchyPlan(4, group_size=2)
        g = m.hier.GroupAggregator(plan, 0, "int8lat")
        for sid in (0, 1):
            g.submit_encoded(sid, 1, m.encode(_grads(7), sid, 1))
        return g.collect_and_reencode(1), g.hops

    (out, hops), (want, _) = _both(body)
    step, wsum, tree = out
    assert (step, wsum) == want[:2] == (1, 2.0) and hops == 1
    assert_bitwise(tree, want[2])
    member = _decode_payload_tree(_encode(_grads(7), 0, 1))
    assert_bitwise(_decode_payload_tree(tree), member)


def test_group_hop_mean_within_one_lattice_step():
    """Distinct members: the re-encode rounds the pooled mean by at most
    one int8lat step (2^-7 of the leaf's max) a hop; the payloads are the
    JAX hop's, bitwise."""
    def body(m):
        plan = m.hier.HierarchyPlan(2, group_size=2)
        g = m.hier.GroupAggregator(plan, 0, "int8lat")
        flat = m.SGA(2, compress=True, codec="int8lat")
        for sid in (0, 1):
            enc = m.encode(_grads(100 + sid), sid, 1)
            g.submit_encoded(sid, 1, enc)
            flat.submit_encoded(sid, 1, enc)
        return g.collect_and_reencode(1)[2], flat.collect(1)[0]

    (tree, want), (jtree, jwant) = _both(body)
    assert_bitwise(tree, jtree)
    assert_bitwise(want, jwant)
    for a, b in zip(_leaves(_decode_payload_tree(tree)), _leaves(want)):
        tol = float(np.max(np.abs(b))) * 2.0 ** -7 + 1e-7
        assert float(np.max(np.abs(a - b))) <= tol


def test_group_hop_rejects_foreign_member_and_empty_pool():
    plan = HierarchyPlan(4, group_size=2)
    g = GroupAggregator(plan, 0, "int8lat")
    with pytest.raises(ValueError, match="not in group"):
        g.submit_encoded(2, 1, _encode(_grads(1), 2, 1))
    assert g.collect_and_reencode(1) is None
    with pytest.raises(ValueError, match="grad_codec"):
        GroupAggregator(plan, 0, "blosc")


def test_group_hop_ef_state_roundtrip_bitwise():
    """The hop's residual after one re-encode equals the JAX hop's, and
    survives a save / load."""
    def body(m):
        plan = m.hier.HierarchyPlan(2, group_size=2)
        g = m.hier.GroupAggregator(plan, 0, "int8lat", hop_ef=True)
        for sid in (0, 1):
            g.submit_encoded(sid, 1, m.encode(_grads(50 + sid), sid, 1))
        g.collect_and_reencode(1)
        return g.ef_state_dict()

    state, want = _both(body)
    assert state
    assert_bitwise(state, want)
    g2 = GroupAggregator(HierarchyPlan(2, group_size=2), 0, "int8lat",
                         hop_ef=True)
    g2.load_ef_state(state)
    assert_bitwise(g2.ef_state_dict(), state)


# ---- tier 2: the root pool and the subtree lifecycle ----

def test_root_weighting_reproduces_flat_average():
    """sum_g(w_g * avg_g) / sum_g(w_g) == sum_i(g_i) / N when fresh, up to
    the hops' rounding; the root's average and info are the JAX root's."""
    def body(m):
        n, gsz = 4, 2
        plan = m.hier.HierarchyPlan(n, group_size=gsz)
        root = m.hier.RootAggregator(plan.n_groups, "int8lat")
        flat = m.SGA(n, compress=True, codec="int8lat")
        groups = [m.hier.GroupAggregator(plan, g, "int8lat")
                  for g in range(plan.n_groups)]
        for sid in range(n):
            enc = m.encode(_grads(200 + sid), sid, 1)
            groups[plan.group_of(sid)].submit_encoded(sid, 1, enc)
            flat.submit_encoded(sid, 1, enc)
        for g in groups:
            step, wsum, tree = g.collect_and_reencode(1)
            root.submit_group(g.gid, step, wsum, tree)
        return root.collect(1), flat.collect(1)[0]

    ((avg, info), want), ((javg, jinfo), _) = _both(body)
    assert info == jinfo
    assert info["used"] == [0, 1] and not info["degraded"]
    assert info["weights"] == {0: 2.0, 1: 2.0}
    assert_bitwise(avg, javg)
    for a, b in zip(_leaves(avg), _leaves(want)):
        tol = float(np.max(np.abs(b))) * 2.0 ** -6 + 1e-7
        assert float(np.max(np.abs(a - b))) <= tol


def _group_payload(m, plan, gid, step):
    """One single-member group hop -> (step, wsum, payload tree)."""
    g = m.hier.GroupAggregator(plan, gid, "int8lat")
    sid = plan.members(gid)[0]
    g.submit_encoded(sid, step, m.encode(_grads(step), sid, step))
    return g.collect_and_reencode(step)


def test_root_partition_degrade_regraft_lifecycle():
    """Group 1 goes silent: a partition declared once at step 4, updates
    go on from group 0 (degraded), one fresh contribution re-grafts. The
    averages, events and counters are the JAX root's, bitwise."""
    def body(m):
        events, avgs = [], []
        plan = m.hier.HierarchyPlan(2, group_size=1)
        root = m.hier.RootAggregator(2, "int8lat", staleness_limit=2,
                                     on_event=lambda *a: events.append(a))

        def feed(gid, step):
            s, wsum, tree = _group_payload(m, plan, gid, step)
            root.submit_group(gid, s, wsum, tree)

        feed(0, 1)
        feed(1, 1)
        avg, info = root.collect(1)
        assert avg is not None and root.groups_healthy() == 2
        avgs.append((avg, info))
        root.consume(info["used"])
        for step in (2, 3, 4, 5):
            feed(0, step)
            avg, info = root.collect(step)
            assert avg is not None            # degraded continuation
            avgs.append((avg, info))
            root.consume(info["used"])
        assert root.counters["partitions"] == 1
        assert root.groups_healthy() == 1
        assert root.counters["degraded_steps"] >= 2
        feed(1, 6)
        feed(0, 6)
        avg, info = root.collect(6)
        avgs.append((avg, info))
        assert sorted(info["used"]) == [0, 1] and not info["degraded"]
        assert root.counters["regrafts"] == 1 and root.groups_healthy() == 2
        return events, root.snapshot(), avgs

    (events, snap, avgs), (jevents, jsnap, javgs) = _both(body)
    assert [e for e in events if e[0] == "partition"] == \
        [("partition", 1, 4, 3)]
    assert ("regraft", 1, 6, 0) in events
    assert events == jevents and snap == jsnap
    assert snap["partitions"] == 1 and snap["groups_healthy"] == 2
    for (a, i), (b, j) in zip(avgs, javgs):
        assert i == j
        assert_bitwise(a, b)


def test_root_stale_pre_partition_aggregate_dropped_by_filter():
    root = RootAggregator(1, "int8lat", staleness_limit=2)
    plan = HierarchyPlan(1, group_size=1)
    step, wsum, tree = _group_payload(PKG["port"], plan, 0, 1)
    root.submit_group(0, step, wsum, tree)
    avg, info = root.collect(9)           # 8 versions later
    assert avg is None and info["dropped_stale"] == [0]
    assert root.counters["partitions"] == 1
    assert root.drop_older_than(9) == 1


def test_root_k_of_n_over_groups():
    def body(m):
        root = m.hier.RootAggregator(3, "int8lat", num_aggregate=2)
        plan = m.hier.HierarchyPlan(3, group_size=1)
        for gid, step in ((0, 5), (1, 4), (2, 3)):   # staleness 0, 1, 2
            g = m.hier.GroupAggregator(plan, gid, "int8lat")
            g.submit_encoded(gid, step, m.encode(_grads(gid), gid, step))
            root.submit_group(gid, *g.collect_and_reencode(step))
        return root.collect(5)

    (avg, info), (javg, jinfo) = _both(body)
    assert info == jinfo
    assert info["used"] == [0, 1] and info["degraded"]
    assert_bitwise(avg, javg)


@pytest.mark.parametrize("bad", [
    lambda m: m.RootAggregator(0, "int8lat"),
    lambda m: m.RootAggregator(2, "int8lat", num_aggregate=3),
    lambda m: m.RootAggregator(2, "int8lat").submit_group(0, 1, 0.0, []),
    lambda m: m.RootAggregator(2, "int8lat").submit_group(2, 1, 1.0, []),
    lambda m: m.RootAggregator(2, "blosc")])
def test_root_validation(bad):
    msgs = []
    for mod in (hier, jax_hier):
        with pytest.raises(ValueError) as e:
            bad(mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_root_payload_tree_flattens_payloads_as_leaves():
    """A payload tree of nested dicts whose leaves are int8lat ``{"v",
    "e"}`` dicts: the root sums one payload a gradient leaf (splitting a
    payload into its arrays would sum scales as values)."""
    tree = {"conv": {"kernel": _encode({"x": _grads(3)["w"]}, 0, 1)["x"],
                     "bias": _encode({"x": _grads(4)["b"]}, 0, 1)["x"]}}
    root = RootAggregator(1, "int8lat")
    root.submit_group(0, 1, 1.0, tree)
    avg, _ = root.collect(1)
    assert sorted(avg) == ["conv"] and sorted(avg["conv"]) == ["bias",
                                                                "kernel"]
    jroot = jax_hier.RootAggregator(1, "int8lat")
    jroot.submit_group(0, 1, 1.0, tree)
    assert_bitwise(avg, jroot.collect(1)[0])
    assert_bitwise(avg, _decode_payload_tree(tree))


# ---- both tiers in one process ----

def test_hier_aggregator_matches_flat_within_hop_rounding():
    def body(m):
        n = 4
        agg = m.hier.HierarchicalAggregator(n, group_size=2,
                                            codec="int8lat")
        flat = m.SGA(n, compress=True, codec="int8lat")
        for sid in range(n):
            g = _grads(300 + sid)
            agg.submit(sid, 1, g)
            flat.submit(sid, 1, g)
        return agg.collect(1), flat.collect(1)[0]

    ((avg, info), want), ((javg, jinfo), _) = _both(body)
    assert info == jinfo
    assert sorted(info["used"]) == [0, 1, 2, 3]
    assert info["used_groups"] == [0, 1]
    assert_bitwise(avg, javg)
    for a, b in zip(_leaves(avg), _leaves(want)):
        tol = float(np.max(np.abs(b))) * 2.0 ** -6 + 1e-7
        assert float(np.max(np.abs(a - b))) <= tol


def test_hier_aggregator_deterministic_and_ef_roundtrip():
    """The same submissions give bitwise the same averages and EF state,
    in the port twice and in the JAX package; the member + hop EF dict
    survives a save / load; a flat checkpoint's residuals go to the
    member tier."""
    def body(m):
        agg = m.hier.HierarchicalAggregator(4, group_size=2,
                                            codec="int8lat",
                                            error_feedback=True, hop_ef=True)
        outs = []
        for step in (1, 2, 3):
            for sid in range(4):
                agg.submit(sid, step, _grads(17 * sid + step))
            avg, info = agg.collect(step)
            agg.consume(info["used"])
            outs.append(avg)
        return agg.ef_state_dict(), outs

    sa, outs_a = body(PKG["port"])
    sb, outs_b = body(PKG["port"])
    sj, outs_j = body(PKG["jax"])
    for ta, tb, tj in zip(outs_a, outs_b, outs_j):
        assert_bitwise(ta, tb)
        assert_bitwise(ta, tj)
    assert_bitwise(sa, sb)
    assert_bitwise(sa, sj)
    assert "members" in sa and any(k.startswith("g") for k in sa)
    c = HierarchicalAggregator(4, group_size=2, codec="int8lat",
                               error_feedback=True, hop_ef=True)
    c.load_ef_state(sa)
    assert_bitwise(c.ef_state_dict(), sa)
    d = HierarchicalAggregator(4, group_size=2, codec="int8lat",
                               error_feedback=True)
    d.load_ef_state(sa["members"])
    assert d.ef_state_dict()["members"].keys() == sa["members"].keys()


def test_hier_aggregator_inter_every_amortizes_upward_hops():
    agg = HierarchicalAggregator(2, group_size=2, codec="int8lat",
                                 inter_every=2)
    agg.submit(0, 1, _grads(1))
    agg.submit(1, 1, _grads(2))
    avg, _ = agg.collect(1)               # no up-link due: payloads stay
    assert avg is None
    agg.submit(0, 2, _grads(3))
    agg.submit(1, 2, _grads(4))
    avg, info = agg.collect(2)            # the group hop and the up-link
    assert avg is not None and info["used_groups"] == [0]
    assert info["used"] == [0, 1]


def test_hier_inter_every_average_is_latest_wins_not_discarded():
    """inter_every=2: the skipped round leaves the member payloads pooled,
    so round 2's average is the flat average of the LATEST submissions;
    and it is the JAX aggregator's, bitwise."""
    def body(m):
        agg = m.hier.HierarchicalAggregator(4, group_size=2,
                                            codec="int8lat", inter_every=2)
        flat = m.SGA(4, compress=True, codec="int8lat")
        for sid in range(4):
            agg.submit(sid, 1, _grads(50 + sid))
        avg, info = agg.collect(1)
        assert avg is None and info["used"] == []
        for sid in (0, 1):
            g = _grads(60 + sid)
            agg.submit(sid, 2, g)
            flat.submit(sid, 2, g)
        for sid in (2, 3):
            flat.submit(sid, 1, _grads(50 + sid))
        return agg.collect(2), flat.collect(2)[0]

    ((avg, info), want), ((javg, jinfo), _) = _both(body)
    assert avg is not None and sorted(info["used"]) == [0, 1, 2, 3]
    assert info == jinfo
    assert_bitwise(avg, javg)
    for a, b in zip(_leaves(avg), _leaves(want)):
        tol = float(np.max(np.abs(b))) * 2.0 ** -6 + 1e-7
        assert float(np.max(np.abs(a - b))) <= tol


def test_hier_num_aggregate_clamped_to_group_count():
    agg = HierarchicalAggregator(8, group_size=3, num_aggregate=4,
                                 codec="int8lat")
    assert agg.root.k == agg.plan.n_groups == 3


def test_hier_kofn_leftover_average_reports_its_members():
    agg = HierarchicalAggregator(2, group_size=1, num_aggregate=1,
                                 codec="int8lat")
    agg.submit(0, 1, _grads(1))
    agg.submit(1, 1, _grads(2))
    avg, info = agg.collect(1)
    assert avg is not None and info["used_groups"] == [0]
    assert info["used"] == [0]
    avg, info = agg.collect(2)            # the leftover group 1 now
    assert avg is not None and info["used_groups"] == [1]
    assert info["used"] == [1]
    avg, info = agg.collect(3)
    assert avg is None and info["used"] == []


def test_hier_members_may_submit_device_tensors():
    """Member gradients arrive as tensors (on the card in a trainer): the
    averages are bitwise those of their numpy copies."""
    import torch

    outs = []
    for as_tensor in (False, True):
        agg = HierarchicalAggregator(4, group_size=2, codec="int8lat",
                                     error_feedback=True)
        for sid in range(4):
            g = _grads(80 + sid)
            if as_tensor:
                g = {k: torch.as_tensor(v) for k, v in g.items()}
            agg.submit(sid, 1, g)
        outs.append((agg.collect(1)[0], agg.ef_state_dict()))
    assert_bitwise(outs[0][0], outs[1][0])
    assert_bitwise(outs[0][1], outs[1][1])


# ---- the drill's bitwise phase ----

def test_drill_bitwise_phase_reproduces_the_jax_arc(monkeypatch, tmp_path):
    """The port's drill phase: RESILIENCE_r14.json's events and counters,
    the JAX drill phase's, and its final vector bitwise the one the JAX
    package's HierarchicalAggregator gives in the same recurrence."""
    with open(os.path.join(REPO, "RESILIENCE_r14.json")) as f:
        r14 = json.load(f)["phases"]["bitwise"]
    got = hierarchy_drill._phase_bitwise()
    assert got["ok"] and got["bitwise_equal"]
    assert got["events"] == r14["events"] == \
        [["partition", 1, 12, 5], ["regraft", 1, 15, 0]]
    assert got["counters"] == r14["counters"] == {
        "hops": 32, "partitions": 1, "regrafts": 1, "degraded_steps": 7}
    want = jax_drill._phase_bitwise()
    assert (want["events"], want["counters"]) == (got["events"],
                                                  got["counters"])
    other = hierarchy_drill._phase_bitwise(
        agg_cls=jax_hier.HierarchicalAggregator)
    assert other["final"]["w"].tobytes() == got["final"]["w"].tobytes()
    assert other["final_sha256"] == got["final_sha256"]
    # The bench phase: the hier-against-flat row (1 MB, 10 ms across
    # regions), its artifact section the JAX drill's.
    import bench_suite as jax_suite
    from ps_pytorch_tpu_torch import bench_suite
    full = bench_suite.bench_hier_agg
    monkeypatch.setattr(bench_suite, "bench_hier_agg", lambda *a, **k: full(
        *a, **{**k, "payload_mb": 1, "inter_rtt_ms": 10.0}))
    out = tmp_path / "bench.json"
    rc = hierarchy_drill.main(["--phase", "bench", "--run-dir",
                               str(tmp_path), "--out", str(out)])
    art = json.loads(out.read_text())
    row = art["phases"]["bench"]
    want = jax_suite.bench_hier_agg("drill_hier_bench", 1, payload_mb=1,
                                    leaf_kb=256, n_slices=4, group_size=2,
                                    inter_rtt_ms=10.0)
    assert set(row) == set(want) and row["n_groups"] == 2
    assert row["rel_err"] < 0.05
    assert set(art["hierarchy"]["bench"]) == {"flat_s", "hier_s",
                                              "speedup", "rel_err"}
    assert rc == (0 if art["ok"] else 1)
    with pytest.raises(ValueError, match="JAX drill"):
        hierarchy_drill.main(["--phase", "bitwise", "--out",
                              os.path.join(REPO, "no", "RESILIENCE_r14.json")])


# ---- the cross-process transport over the KV ----

def _transports(m, kv, clock, n=4, gsz=2, **kw):
    tpl = m.encode(_grads(0), 0, 0)
    return [m.hier.HierarchicalKVTransport(
        kv, n, tpl, {"params": _grads(0)}, run_id="t", pid=p,
        group_size=gsz, codec="int8lat", lease_interval_s=1.0,
        clock=clock.time, sleep=lambda _s: None, **kw) for p in range(n)]


def test_transport_pump_publish_poll_roundtrip():
    def body(m):
        clock, kv = m.ManualClock(), m.KV()
        ts = _transports(m, kv, clock)
        for t in ts:
            t.submit_grads(t.pid, 1, 1, m.encode(_grads(400 + t.pid),
                                                 t.pid, 1))
        assert ts[0].pump(1) == 1 and ts[2].pump(1) == 1
        assert ts[0].is_aggregator and ts[2].is_aggregator
        assert not ts[1].is_aggregator
        got = ts[0].poll_new_aggs()
        assert ts[0].poll_new_aggs() == []    # no re-reads
        ws = ts[0].wire_stats()
        assert ts[0].stats["group_publishes"] == 1
        assert ws["hier_hops"] == 1 and ws["hier_hop_giveups"] == 0
        return got, ts[0].describe()

    (got, desc), (jgot, jdesc) = _both(body)
    assert [(g, s, w) for g, s, w, _ in got] == [(0, 1, 2.0), (1, 1, 2.0)]
    assert desc == jdesc
    for a, b in zip(got, jgot):
        assert a[:3] == b[:3]
        assert_bitwise(a[3], b[3])


def test_transport_failover_member_adopts_aggregator_role():
    clock, kv = ManualClock(), KVStore()
    ts = _transports(PKG["port"], kv, clock)
    assert ts[0].pump(1) == 0             # claims the lease, empty pool
    assert ts[0].is_aggregator
    clock.now += 10.0                     # past 3x the lease interval
    ts[1].submit_grads(1, 1, 1, _encode(_grads(9), 1, 1))
    assert ts[1].pump(1) == 1
    assert ts[1].is_aggregator and ts[1].stats["failovers"] == 1
    assert ts[0].stats["failovers"] == 0
    assert kv.get("t/g0/elect/lease") is not None


def test_transport_ahead_member_step_not_dropped():
    clock, kv = ManualClock(), KVStore()
    ts = _transports(PKG["port"], kv, clock)
    ts[1].submit_grads(1, 1, 7, _encode(_grads(9), 1, 7))
    assert ts[0].pump(2) == 1             # the aggregator's clock lags
    ((gid, step, wsum, _),) = ts[0].poll_new_aggs()
    assert (gid, step, wsum) == (0, 7, 1.0)


def test_transport_partition_window_degrades_not_crashes():
    clock, kv = ManualClock(), KVStore()
    inj = FaultInjector("kv_partition:r=0,step=5,steps=2", process_index=0,
                        sleep=lambda _s: None)
    ts = _transports(PKG["port"], inj.wrap_kv(kv), clock, n=2, gsz=2,
                     hop_retries=2)
    t0 = ts[0]
    assert t0.pump(1) == 0 and t0.is_aggregator
    inj.maybe_crash(5)                    # the window opens
    t0._pool.submit_encoded(0, 5, _encode(_grads(5), 0, 5))
    assert t0.pump(5) == 0
    assert t0.stats["hop_giveups"] == 1
    assert inj.counters["kv_partition_drops"] > 0
    assert t0.done() is None and t0.fetch_params() is None
    inj.maybe_crash(7)                    # the heal
    t0._pool.submit_encoded(0, 7, _encode(_grads(7), 0, 7))
    assert t0.pump(7) == 1
    assert t0.stats["hop_giveups"] == 1


def test_pump_publish_version_survives_transient_read_error():
    clock, kv = ManualClock(), KVStore()
    ts = _transports(PKG["port"], kv, clock, n=2, gsz=2)
    t0 = ts[0]
    t0.submit_grads(0, 1, 1, _encode(_grads(1), 0, 1))
    assert t0.pump(1) == 1
    assert [g for g, _, _, _ in t0.poll_new_aggs()] == [0]
    ch = t0._agg_chan(0)
    orig = ch.latest_version
    ch.latest_version = lambda: None      # a transient error's shape
    t0.submit_grads(0, 2, 2, _encode(_grads(2), 0, 2))
    assert t0.pump(2) == 1
    ch.latest_version = orig
    got = t0.poll_new_aggs()
    assert [(g, s) for g, s, _, _ in got] == [(0, 2)]


def test_each_package_reads_the_others_group_publish(tmp_path):
    """Two FileKV directories, the same inputs: in ``p`` the port's
    aggregators of both groups publish, in ``j`` the JAX package's. Every
    key is the same bytes in both; the JAX root reads the port's
    aggregates and the port's root the JAX ones, bitwise equal."""
    clock = ManualClock(start=100.0)
    got = {}
    for sub, m, kv_cls in (("p", PKG["port"], FileKV),
                           ("j", PKG["jax"], JaxFileKV)):
        kv = kv_cls(str(tmp_path / sub))
        ts = _transports(m, kv, clock)
        for t in ts:
            t.submit_grads(t.pid, 1, 1, m.encode(_grads(500 + t.pid),
                                                 t.pid, 1))
        assert ts[0].pump(1) == 1 and ts[2].pump(1) == 1
        ts[0].publish_params(1, {"params": _grads(9)})
        ts[0].set_done(1)
    for k in ("p", "j"):
        got[k] = sorted(FileKV(str(tmp_path / k)).keys("t"))
    assert got["p"] == got["j"]
    assert "t/hagg/1/ver" in got["p"] and "t/hgrad/0/1/1/meta" in got["p"]
    assert "t/g1/elect/lease" in got["p"] and "t/adone" in got["p"]
    for key in got["p"]:
        assert FileKV(str(tmp_path / "p")).get(key) == \
            FileKV(str(tmp_path / "j")).get(key), key
    # Each package's root reads the other's publish.
    reads = {}
    for sub, m, kv_cls in (("p", PKG["jax"], JaxFileKV),
                           ("j", PKG["port"], FileKV)):
        root = _transports(m, kv_cls(str(tmp_path / sub)), clock)[0]
        reads[sub] = root.poll_new_aggs()
        assert root.fetch_params()[0] == 1 and root.done() == 1
    assert [r[:3] for r in reads["p"]] == [r[:3] for r in reads["j"]] == \
        [(0, 1, 2.0), (1, 1, 2.0)]
    for a, b in zip(reads["p"], reads["j"]):
        assert_bitwise(a[3], b[3])
    assert json.loads(hier.meta_json({"b": 1, "a": 2})) == {"a": 2, "b": 1}


# ---- the subtree-scoped fault grammar ----

def test_kv_partition_group_scope_parses_and_self_scopes():
    faults = parse_fault_spec("kv_partition:group=1,gsize=2,step=3,steps=2")
    assert faults[0]["group"] == 1 and faults[0]["gsize"] == 2
    for pid, hit in ((0, False), (1, False), (2, True), (3, True),
                     (4, False)):
        inj = FaultInjector("kv_partition:group=1,gsize=2,step=3,steps=2",
                            process_index=pid, sleep=lambda _s: None)
        kv = inj.wrap_kv(KVStore())
        inj.maybe_crash(3)                # the window is open
        if hit:
            with pytest.raises(TransientKVError, match="kv_partition"):
                kv.set("k", "v")
            inj.maybe_crash(5)            # and closed
            kv.set("k", "v")
        else:
            kv.set("k", "v")
            assert inj.counters["kv_partition_drops"] == 0


def test_link_jitter_prefix_scoped_delay():
    sleeps = []
    inj = FaultInjector("link_jitter:s=0.02,prefix=t/hagg",
                        process_index=0, sleep=sleeps.append)
    kv = inj.wrap_kv(KVStore())
    kv.set("t/hgrad/0/1", "x")            # the fast link: untouched
    assert sleeps == []
    kv.set("t/hagg/0", "x")               # the up-link: delayed
    kv.get("t/hagg/0")
    assert sleeps == [0.02, 0.02]
    assert inj.counters["link_jitters"] == 2


@pytest.mark.parametrize("bad", [
    "kv_partition:group=-1,step=1,steps=1",
    "kv_partition:group=1,gsize=0,step=1,steps=1",
    "kv_partition:group=1,r=0,step=1,steps=1",
    "link_jitter:prefix=x", "link_jitter:s=0,p=2"])
def test_fault_spec_validation_errors(bad):
    msgs = []
    for parse in (parse_fault_spec, jax_res.parse_fault_spec):
        with pytest.raises(ValueError) as e:
            parse(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
