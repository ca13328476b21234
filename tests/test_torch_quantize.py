"""The port's int8 quantizer, host codecs and buckets against the JAX
package, on the CPU.

``ops/quantize.py``'s plain version is held BITWISE (values and scales)
against ``_quantize_padded`` in Pallas interpret mode on the same ``x`` and
noise; the ``PSC1`` containers of ``compression/`` are byte-equal for both
codecs and cross-readable; every payload, compressed-domain sum and
error-feedback state of ``compression/codecs.py`` is bitwise the JAX
package's; ``parallel/buckets.py`` plans the same buckets and the int8
payload does not depend on bucket size or worker count. Inputs are made
with numpy from a seed and handed to both packages. The CUDA kernel itself
is held against the plain version on the card by test_torch_kernels.py.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import compression as jax_compression
from ps_pytorch_tpu.compression import codecs as jax_codecs
from ps_pytorch_tpu.parallel import buckets as jax_buckets
from ps_pytorch_tpu_torch import compression
from ps_pytorch_tpu_torch.compression import codecs
from ps_pytorch_tpu_torch.ops import quantize as tq
from ps_pytorch_tpu_torch.parallel import buckets
from ps_pytorch_tpu_torch.parallel.async_dp import StaleGradientAggregator
from test_torch_train import two_torch_threads  # noqa: F401

# The package re-exports the function under the module's name.
jq = importlib.import_module("ps_pytorch_tpu.ops.quantize")


# ----------------------------------------------------------- quantize --

def _leaf(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "scalar0d":
        return np.asarray(rng.normal(), np.float32)
    if case == "zero":
        return np.zeros((3, 5000), np.float32)
    if case == "huge":
        x = rng.normal(size=(2, 4096)).astype(np.float32) * 1e-3
        x[1, 17] = 3e38
        return x
    if case == "tiny":
        return np.full((4097,), 1e-42, np.float32)
    shape = {"one": (1,), "block": (4096,), "block_plus_1": (4097,),
             "ragged": (100_003,), "conv": (3, 3, 16, 32),
             "bias": (10,)}[case]
    scale = {"one": 1.0, "block": 300.0, "block_plus_1": 1e-6,
             "ragged": 1e-3, "conv": 0.05, "bias": 1.0}[case]
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _padded(x):
    rows = tq.padded_rows(x.size)
    flat = np.zeros(rows * tq.LANES, np.float32)
    flat[:x.size] = x.reshape(-1)
    return flat.reshape(rows, tq.LANES)


CASES = ["scalar0d", "one", "bias", "block", "block_plus_1", "ragged",
         "conv", "zero", "huge", "tiny"]


@pytest.mark.parametrize("case", CASES)
def test_quantize_matches_jax_bitwise(case):
    """Values and scales bitwise, and the dequantized leaf and the wire
    size equal, for ragged, 0-d, all-zero and one-huge-value leaves."""
    x = _leaf(case)
    x2d = _padded(x)
    noise = np.random.default_rng(7).random(x2d.shape, dtype=np.float32)
    jv, js = jq._quantize_padded(jnp.asarray(x2d), jnp.asarray(noise), True)
    qt = tq.quantize_int8(torch.from_numpy(x), torch.from_numpy(noise))
    assert qt.values.dtype == torch.int8 and qt.scales.dtype == torch.float32
    assert tuple(qt.values.shape) == jv.shape
    assert tuple(qt.scales.shape) == js.shape
    assert qt.values.numpy().tobytes() == np.asarray(jv).tobytes()
    assert qt.scales.numpy().tobytes() == np.asarray(js).tobytes()
    assert (qt.shape, qt.size) == (x.shape, max(x.size, 1))
    jqt = jq.QuantizedTensor(jv, js, x.shape, max(x.size, 1))
    back = tq.dequantize_int8(qt)
    assert tuple(back.shape) == x.shape
    assert back.numpy().tobytes() == np.asarray(
        jq.dequantize_int8(jqt)).tobytes()
    assert tq.quantized_nbytes(qt) == jq.quantized_nbytes(jqt)
    if case == "zero":                  # scale floor, zeros out
        assert float(qt.scales.max()) == float(np.float32(1e-30))
        assert not qt.values.any()


def test_quantize_bfloat16_leaf_is_cast_like_jax():
    x = np.random.default_rng(3).normal(size=(5000,)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    noise = np.random.default_rng(4).random((64, 128), dtype=np.float32)
    x2d = _padded(xb.float().numpy())
    jv, js = jq._quantize_padded(jnp.asarray(x2d), jnp.asarray(noise), True)
    qt = tq.quantize_int8(xb, torch.from_numpy(noise))
    assert qt.values.numpy().tobytes() == np.asarray(jv).tobytes()
    assert qt.scales.numpy().tobytes() == np.asarray(js).tobytes()


def test_quantize_error_within_one_quantum_and_unbiased():
    """|dequantize - x| <= one quantum per block, and the mean of 64 draws
    lies within a quarter quantum of x (the JAX package's own check)."""
    x = (np.random.default_rng(0).normal(size=(2, 4096)) * 0.1).astype(
        np.float32)
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros_like(xt)
    for _ in range(64):
        qt = tq.quantize_int8(xt, generator=gen)
        back = tq.dequantize_int8(qt)
        quantum = qt.scales.reshape(2, 1)
        assert bool(((back - xt).abs() <= quantum * (1 + 1e-6)).all())
        acc += back
    assert bool(((acc / 64 - xt).abs() <= quantum / 4).all())


def test_quantize_generator_is_reproducible_and_checked():
    x = torch.from_numpy(_leaf("ragged"))
    a = tq.quantize_int8(x, generator=torch.Generator().manual_seed(5))
    b = tq.quantize_int8(x, generator=torch.Generator().manual_seed(5))
    c = tq.quantize_int8(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a.values, b.values) and torch.equal(a.scales, b.scales)
    assert not torch.equal(a.values, c.values)
    assert tq.quantize_int8.launches == 0          # the CPU never launches
    with pytest.raises(ValueError, match="noise"):
        tq.quantize_int8(x, torch.zeros(32, 128))
    with pytest.raises(ValueError, match="noise"):
        tq.quantize_int8(x, torch.zeros(800, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="empty"):
        tq.quantize_int8(torch.zeros(0))
    with pytest.raises(ValueError):
        tq.quantize_int8(x, torch.zeros(800, 128, device="meta"))


# ------------------------------------------------ Philox and the tree --

def _np_philox(counter, key):
    """Philox4x32-10 in numpy uint32 words, products in uint64: written
    here from the paper, independent of the port's int64 version."""
    c = [np.atleast_1d(np.asarray(w, np.uint32)) for w in counter]
    k = [np.uint32(key[0]), np.uint32(key[1])]
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    for r in range(10):
        if r:
            k = [np.uint32((int(k[0]) + 0x9E3779B9) % 2 ** 32),
                 np.uint32((int(k[1]) + 0xBB67AE85) % 2 ** 32)]
        p0 = m0 * c[0].astype(np.uint64)
        p1 = m1 * c[2].astype(np.uint64)
        hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), p0.astype(
            np.uint32)
        hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), p1.astype(
            np.uint32)
        c = [hi1 ^ c[1] ^ k[0], lo1, hi0 ^ c[3] ^ k[1], lo0]
    return c


# Random123's known-answer vectors for philox4x32-10: counter, key, output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("case", range(len(PHILOX_KAT)))
def test_philox_known_answers(case):
    counter, key, want = PHILOX_KAT[case]
    got = tq.philox4x32([torch.tensor([w], dtype=torch.int64)
                         for w in counter], key)
    assert tuple(int(w[0]) for w in got) == want
    assert tuple(int(w[0]) for w in _np_philox(counter, key)) == want


def test_philox_matches_numpy_bitwise():
    """Random counters and keys, words up to 2^32 - 1: the int64 version
    (16-bit halves, no overflow) is the uint32 one bit for bit."""
    rng = np.random.default_rng(0)
    counter = [rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
               for _ in range(4)]
    for key in ((0, 0), (1, 2), (0xFFFFFFFF, 7), (123456789, 0xDEADBEEF)):
        got = tq.philox4x32([torch.from_numpy(w.astype(np.int64))
                             for w in counter], key)
        want = _np_philox([w.astype(np.uint32) for w in counter], key)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w.astype(np.int64))


def test_philox_uniform_is_the_counter_stream_in_unit_interval():
    """Element e of leaf i is word e % 4 of counter (e // 4, i, 0, 0), as
    (bits >> 8) * 2^-24: exact, in [0, 1), mean about 1/2."""
    key, index, n = (3, 11), 5, 10_001
    u = tq.philox_uniform(key, index, n)
    assert u.dtype == torch.float32 and u.shape == (n,)
    groups = np.arange(-(-n // 4), dtype=np.uint32)
    words = _np_philox([groups, np.full_like(groups, index),
                        np.zeros_like(groups), np.zeros_like(groups)], key)
    bits = np.stack(words, axis=1).reshape(-1)[:n]
    want = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2 ** -24)
    assert u.numpy().tobytes() == want.tobytes()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert not torch.equal(u, tq.philox_uniform(key, index + 1, n))
    assert not torch.equal(u, tq.philox_uniform((3, 12), index, n))


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(np.asarray(rng.normal(size=s) * sc,
                                          np.float32)) for s, sc in (((5, 5, 1, 6), 0.1), ((6,), 1.0),
                            ((400, 120), 1e-3), ((), 2.0), ((3, 5000), 0.0),
                            ((4097,), 5.0))]
    leaves.append(torch.from_numpy(rng.normal(size=(70, 3)).astype(
        np.float32)).bfloat16())
    leaves.append(torch.from_numpy(rng.integers(-9, 9, (33,))))  # cast
    return leaves


def test_tree_quantizer_is_per_leaf_quantize_int8_bitwise():
    """The tree's plain version (Philox noise) equals quantize_int8 leaf by
    leaf with the same noise injected, and the JAX quantizer on it, values
    and scales bitwise; with injected noise the tree equals quantize_int8
    with the same noise."""
    leaves, key = _tree(), (1, 9)
    got = tq.quantize_tree(leaves, key)
    injected = [np.random.default_rng(i).random(
        (tq.padded_rows(l.numel()), tq.LANES), dtype=np.float32)
        for i, l in enumerate(leaves)]
    got_injected = tq.quantize_tree(leaves, noise=[torch.from_numpy(u)
                                                   for u in injected])
    for i, leaf in enumerate(leaves):
        rows = tq.padded_rows(leaf.numel())
        u = tq.philox_uniform(key, i, rows * tq.LANES).reshape(rows, tq.LANES)
        for qt, noise in ((got[i], u), (got_injected[i],
                                        torch.from_numpy(injected[i]))):
            want = tq.quantize_int8(leaf, noise)
            assert torch.equal(qt.values, want.values)
            assert torch.equal(qt.scales, want.scales)
            assert (qt.shape, qt.size) == (want.shape, want.size) == \
                (tuple(leaf.shape), max(leaf.numel(), 1))
        jv, js = jq._quantize_padded(jnp.asarray(_padded(
            leaf.float().numpy())), jnp.asarray(u.numpy()), True)
        assert got[i].values.numpy().tobytes() == np.asarray(jv).tobytes()
        assert got[i].scales.numpy().tobytes() == np.asarray(js).tobytes()
    assert not got[4].values.any()          # the all-zero leaf
    assert tq.quantize_int8.launches == 0   # the CPU never launches


def test_tree_quantizer_checks_its_inputs():
    leaves = _tree()[:2]
    with pytest.raises(ValueError, match="at least one"):
        tq.quantize_tree([])
    with pytest.raises(ValueError, match="empty"):
        tq.quantize_tree([leaves[0], torch.zeros(0)])
    with pytest.raises(ValueError, match="noise tensors"):
        tq.quantize_tree(leaves, noise=[torch.zeros(32, 128)])
    with pytest.raises(ValueError, match="noise"):
        tq.quantize_tree(leaves, noise=[torch.zeros(32, 128),
                                        torch.zeros(32, 64)])
    with pytest.raises(ValueError):
        tq.quantize_tree([leaves[0], leaves[1].to("meta")])


def test_philox_noise_keeps_the_quantizer_unbiased():
    """|dequantize - x| <= one quantum, and the mean of 64 draws under 64
    keys (the aggregator's steps) lies within a quarter quantum of x."""
    x = (np.random.default_rng(0).normal(size=(2, 4096)) * 0.1).astype(
        np.float32)
    xt = torch.from_numpy(x)
    acc = torch.zeros_like(xt)
    for step in range(64):
        qt = tq.quantize_tree([xt], (1, step))[0]
        back = tq.dequantize_int8(qt)
        quantum = qt.scales.reshape(2, 1)
        assert bool(((back - xt).abs() <= quantum * (1 + 1e-6)).all())
        acc += back
    assert bool(((acc / 64 - xt).abs() <= quantum / 4).all())


def test_quantize_constants_match_jax():
    assert (tq.LANES, tq.BLOCK_ROWS, tq.BLOCK) == (jq.LANES, jq.BLOCK_ROWS,
                                                   jq.BLOCK)
    assert tq.QuantizedTensor._fields == jq.QuantizedTensor._fields


# -------------------------------------------------------- compression --

ARRAYS = {
    "f32": lambda r: r.normal(size=(37, 11)).astype(np.float32),
    "f32_0d": lambda r: np.asarray(r.normal(), np.float32),
    "u8_blob": lambda r: r.integers(0, 256, 5001).astype(np.uint8),
    "i8": lambda r: r.integers(-127, 128, (32, 128)).astype(np.int8),
    "f64": lambda r: r.normal(size=(3, 4, 5)),
    "i32_empty": lambda r: np.zeros((0, 4), np.int32),
}


def _force_zlib(monkeypatch):
    for mod in (compression, jax_compression):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_tried", True)


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("codec", ["native", "zlib"])
def test_psc_containers_match_jax(monkeypatch, codec, name):
    """The container is byte-equal to the JAX package's for the zstd
    library and for the zlib path, and each package reads the other's."""
    if codec == "zlib":
        _force_zlib(monkeypatch)
    elif not jax_compression.have_native():
        pytest.skip("the native codec library is not built here")
    arr = ARRAYS[name](np.random.default_rng(1))
    for level in (1, 3):
        ours = compression.g_compress(arr, level=level)
        theirs = jax_compression.g_compress(arr, level=level)
        assert ours == theirs
        assert ours[:4] == b"PSC1"
        assert ours[4] == (2 if codec == "zlib" else 1)
    for blob in (ours, theirs):
        for mod in (compression, jax_compression):
            back = mod.w_decompress(blob)
            assert back.dtype == arr.dtype and back.shape == arr.shape
            assert back.tobytes() == arr.tobytes()
    assert compression.codec_name() == ("zlib" if codec == "zlib" else "zstd")


def test_zlib_reader_reads_native_containers_and_refuses_garbage(monkeypatch):
    if not compression.have_native():
        pytest.skip("the native codec library is not built here")
    arr = ARRAYS["f32"](np.random.default_rng(2))
    native_blob = compression.w_compress(arr)
    assert np.array_equal(compression.w_decompress(native_blob), arr)
    _force_zlib(monkeypatch)
    zlib_blob = compression.w_compress(arr)
    assert zlib_blob != native_blob
    with pytest.raises(RuntimeError, match="native"):
        compression.w_decompress(native_blob)
    with pytest.raises(ValueError, match="PSC"):
        compression.w_decompress(b"XXXX" + zlib_blob[4:])


# ------------------------------------------------------------- codecs --

def _grad_leaves(seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.normal(size=s) * sc, np.float32) for s, sc in (
        ((5, 5, 1, 6), 0.1), ((6,), 1.0), ((400, 120), 1e-3), ((), 2.0),
        ((84, 10), 5.0), ((10,), 0.0))]


def _assert_payloads_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_codec_registries_and_error_match_jax():
    for name in ("CHANNEL_CODECS", "GRAD_CODECS", "HOMOMORPHIC_GRAD_CODECS",
                 "EF_GRAD_CODECS"):
        assert getattr(codecs, name) == getattr(jax_codecs, name)
    msgs = []
    for mod in (codecs, jax_codecs):
        with pytest.raises(ValueError) as e:
            mod.require_codec("grad_codec", "zip", mod.GRAD_CODECS)
        msgs.append(str(e.value))
        assert mod.require_codec("grad_codec", "int8", mod.GRAD_CODECS) \
            == "int8"
        with pytest.raises(ValueError, match="unknown grad_codec"):
            mod.get_grad_codec("int8")
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("frac", [0.01, 0.3, 1.0])
@pytest.mark.parametrize("name", ["int8lat", "topk", "randk"])
def test_codec_payloads_and_sums_match_jax(name, frac):
    """Every payload, its decode, the compressed-domain weighted sum and
    decode-then-average, bitwise."""
    ours, theirs = codecs.get_grad_codec(name), jax_codecs.get_grad_codec(name)
    contribs = {mod: [] for mod in ("ours", "theirs")}
    for sid, w in ((0, 1.0), (1, 0.5), (2, 0.25)):
        pa, pb = [], []
        for i, leaf in enumerate(_grad_leaves(10 + sid)):
            kw = dict(slice_id=sid, step=4, leaf_index=i, frac=frac)
            a, b = ours.encode(leaf, **kw), theirs.encode(leaf, **kw)
            _assert_payloads_equal(a, b)
            assert ours.decode(a).tobytes() == theirs.decode(b).tobytes()
            assert ours.payload_shape(a) == theirs.payload_shape(b)
            assert codecs.payload_nbytes(a) == jax_codecs.payload_nbytes(b)
            assert codecs.is_payload(a) and not codecs.is_payload(leaf)
            pa.append(a)
            pb.append(b)
        contribs["ours"].append((w, pa))
        contribs["theirs"].append((w, pb))
    n_leaves = len(contribs["ours"][0][1])
    for i in range(n_leaves):
        sa, sb = ours.sum_init(), theirs.sum_init()
        for (w, pa), (_, pb) in zip(contribs["ours"], contribs["theirs"]):
            ours.sum_add(sa, pa[i], w)
            theirs.sum_add(sb, pb[i], w)
        shape = ours.payload_shape(contribs["ours"][0][1][i])
        got = ours.sum_finish(sa, 1.75, shape)
        want = theirs.sum_finish(sb, 1.75, shape)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    for got, want in zip(
            codecs.decode_then_average(name, contribs["ours"]),
            jax_codecs.decode_then_average(name, contribs["theirs"])):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("name", ["int8lat", "topk", "randk"])
def test_error_feedback_state_matches_jax(name, clip):
    """Three steps of encode_leaves with error feedback (bucketed, on a
    worker pool): payloads and the residual state bitwise, and the state
    loads across the packages."""
    ef_a, ef_b = codecs.ErrorFeedback(clip), jax_codecs.ErrorFeedback(clip)
    with ThreadPoolExecutor(2) as pool:
        for step in range(3):
            leaves = _grad_leaves(20 + step)
            kw = dict(slice_id=1, step=step, frac=0.1, bucket_bytes=2048)
            pa = codecs.encode_leaves(name, [torch.from_numpy(l)
                                             for l in leaves],
                                      ef=ef_a, pool=pool, **kw)
            pb = jax_codecs.encode_leaves(name, leaves, ef=ef_b, pool=pool,
                                          **kw)
            for a, b in zip(pa, pb):
                _assert_payloads_equal(a, b)
    sa, sb = ef_a.state_dict(), ef_b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].tobytes() == sb[k].tobytes()
    assert ef_a.residual_nbytes() == ef_b.residual_nbytes()
    back = codecs.ErrorFeedback(clip)
    back.load_state_dict(sb)
    x = _grad_leaves(30)[2]
    assert back.compensate(2, x).tobytes() == ef_b.compensate(2, x).tobytes()


# ------------------------------------------------------------ buckets --

@pytest.mark.parametrize("bucket_bytes", [0, 1, 2048, 100_000, 10 ** 9])
def test_plan_buckets_matches_jax(bucket_bytes):
    leaves = _grad_leaves(0)
    ours = buckets.plan_buckets([torch.from_numpy(l) for l in leaves],
                                bucket_bytes)
    theirs = jax_buckets.plan_buckets(leaves, bucket_bytes)
    assert [(b.index, b.start, b.stop, b.nbytes) for b in ours] == \
        [(b.index, b.start, b.stop, b.nbytes) for b in theirs]
    assert buckets.bucket_counts(ours) == jax_buckets.bucket_counts(theirs)
    assert buckets.plan_buckets([], bucket_bytes) == []
    assert [buckets.leaf_nbytes(l) for l in leaves] == \
        [jax_buckets.leaf_nbytes(l) for l in leaves]


def test_stream_buckets_keeps_order_and_raises():
    leaves = [torch.full((n,), float(n)) for n in (3, 500, 2, 900, 7)]
    plan = buckets.plan_buckets(leaves, 1024)
    want = [[float(l.sum()) for l in leaves[b.start:b.stop]] for b in plan]
    fn = lambda b, block: [float(l.sum()) for l in block]   # noqa: E731
    assert buckets.stream_buckets(leaves, plan, fn) == want
    with ThreadPoolExecutor(3) as pool:
        assert buckets.stream_buckets(leaves, plan, fn, pool) == want

        def boom(b, block):
            if b.index == 1:
                raise KeyError("bucket 1")
            return b.index

        with pytest.raises(KeyError, match="bucket 1"):
            buckets.stream_buckets(leaves, plan, boom, pool)


def _lenet_like_grads(seed):
    rng = np.random.default_rng(seed)
    return {f"layer{i}": {"weight": torch.from_numpy(
        rng.normal(size=s).astype(np.float32)), "bias": torch.from_numpy(
            rng.normal(size=s[-1:]).astype(np.float32))}
        for i, s in enumerate(((25, 6), (150, 16), (256, 120), (120, 84)))}


@pytest.mark.parametrize("bucket_bytes,workers", [(0, 0), (1, 4), (4096, 4),
                                                  (10 ** 9, 2)])
def test_int8_payload_invariant_to_bucketing(bucket_bytes, workers):
    """The quantized pool does not depend on bucket size or worker count:
    the rounding noise is keyed by the global leaf index."""
    grads = _lenet_like_grads(0)
    pools = []
    for bb, ww in ((0, 0), (bucket_bytes, workers)):
        agg = StaleGradientAggregator(2, compress=True, codec="int8",
                                      wire_bucket_bytes=bb, wire_workers=ww)
        agg.submit(1, 3, grads)
        pools.append(agg._pool[1][1])
    for a, b in zip(*pools):
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.scales, b.scales)
        assert (a.shape, a.size) == (b.shape, b.size)
    other = StaleGradientAggregator(2, compress=True, codec="int8")
    other.submit(0, 3, grads)                   # another slice: other noise
    assert not all(torch.equal(a.values, b.values)
                   for a, b in zip(pools[0], other._pool[0][1]))
