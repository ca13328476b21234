"""The port's serving plane (``ps_pytorch_tpu_torch/serving/``) against the
JAX package's, on the CPU: ``tests/test_serving.py``'s cases on the port's
modules, plus the cross-package contracts.

The load-bearing contract is the one of the JAX engine: a request's tokens
are ``generate``'s (the port's own ``models/generate.generate``) at every
slot count and admission order, greedy and sampled, token for token. On
the same weights (``models/convert.py``), the port engine's greedy streams
are the JAX engine's; sampling draws from torch's generator, so sampled
streams are the port's own. Validation and config messages, the admission
queue on a manual clock, hot reload past a corrupt newest checkpoint
(one the JAX package wrote too), and the HTTP front end's status codes and
JSON keys are the JAX package's. The entry point decodes on the CPU only
when asked, and its first JSON line has the root ``serve.py``'s keys.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.parse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu.models.transformer import TransformerLM as JaxLM
from ps_pytorch_tpu.resilience.faults import corrupt_file
from ps_pytorch_tpu.runtime import checkpoint as jax_ckpt
from ps_pytorch_tpu.runtime import lm_eval as jax_lm_eval
from ps_pytorch_tpu.serving import engine as jax_engine
from ps_pytorch_tpu.serving import queue as jax_queue
from ps_pytorch_tpu.serving import server as jax_server
from ps_pytorch_tpu.telemetry import registry as jax_registry
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch import generate as generate_cli
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models.generate import generate
from ps_pytorch_tpu_torch.models.transformer import (
    DecodeCache, TransformerLM, migrate_packed_qkv,
)
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import lm_eval
from ps_pytorch_tpu_torch.serving import queue as port_queue
from ps_pytorch_tpu_torch.serving.engine import (
    Request, ServingEngine, serve_loop,
)
from ps_pytorch_tpu_torch.serving.loadgen import (
    make_requests, run_closed_loop, run_open_loop, summarize,
)
from ps_pytorch_tpu_torch.serving.queue import AdmissionQueue
from ps_pytorch_tpu_torch.serving.reload import CheckpointWatcher
from ps_pytorch_tpu_torch.serving.server import ServingFrontend
from ps_pytorch_tpu_torch.telemetry.registry import (
    Registry, declare_serving_metrics,
)
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
V, D, L, H, S = 61, 32, 2, 2, 96


@pytest.fixture(scope="module")
def params():
    """The JAX package's weights (flax tree of numpy arrays)."""
    model = JaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                  max_seq_len=S)
    return jax.device_get(model.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
        positions=jnp.arange(8))["params"])


@pytest.fixture(scope="module")
def model(params):
    """The same weights in the port's model."""
    m = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                      max_seq_len=S)
    m.load_state_dict(convert.from_jax(params))
    return m


def _engine(model, slots, **kw):
    return ServingEngine(model, slots=slots, **kw)


def _jax_engine(params, slots, **kw):
    return jax_engine.ServingEngine(params, slots=slots, vocab=V, d_model=D,
                                    n_layers=L, n_heads=H, max_seq_len=S,
                                    **kw)


# Mixed shapes and sampling regimes: temp>0 with/without top_k, greedy,
# and an n_new=1 request (completes at admission, never holds a slot).
_SPECS = [
    dict(n_new=7, temperature=0.8, top_k=7, seed=3, plen=5),
    dict(n_new=15, temperature=0.0, top_k=0, seed=1, plen=12),
    dict(n_new=1, temperature=1.3, top_k=5, seed=9, plen=3),
    dict(n_new=10, temperature=0.5, top_k=0, seed=4, plen=8),
    dict(n_new=4, temperature=0.9, top_k=11, seed=7, plen=20),
]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, V, size=s["plen"]).astype(np.int32)
            for s in _SPECS]


def _requests():
    return [Request(prompt=p, n_new=s["n_new"], temperature=s["temperature"],
                top_k=s["top_k"], seed=s["seed"])
            for p, s in zip(_prompts(), _SPECS)]


def _refs(model):
    return [generate(model, p[None], n_new=s["n_new"],
                     temperature=s["temperature"], top_k=s["top_k"],
                     seed=s["seed"])[0, s["plen"]:].tolist()
            for p, s in zip(_prompts(), _SPECS)]


# ---- the cache's per-row form ----

def test_per_row_cache_equals_one_row_caches(model):
    """Rows at their own offsets in one [B] cache give each row's logits
    of a one-row cache at that offset (the JAX engine's vmap), and an
    offset-0 row writes only slot 0 of its own row."""
    rng = np.random.default_rng(5)
    lens = [3, 9, 1]
    prompts = [torch.as_tensor(rng.integers(0, V, n)).long() for n in lens]
    nxt = torch.as_tensor(rng.integers(0, V, 3)).long()
    batch = DecodeCache(model, 3, 32)
    want = []
    with torch.no_grad():
        for b, p in enumerate(prompts):
            one = DecodeCache(model, 1, 32)
            model(p[None], positions=torch.arange(len(p)), cache=one)
            for blk, row in zip(batch.blocks, one.blocks):
                blk.k[b], blk.v[b] = row.k[0], row.v[0]
            want.append(model(nxt[b:b + 1, None],
                              positions=torch.tensor([len(p)]),
                              cache=one)[0, 0])
        pos = torch.tensor(lens)
        batch.set_offsets(pos)
        before = batch.blocks[0].k[2].clone()
        got = model(nxt[:, None], positions=pos[:, None], cache=batch)[:, 0]
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(batch.blocks[0].idx, pos + 1)
    after = batch.blocks[0].k[2]
    assert torch.equal(after[:, 2:], before[:, 2:])     # only slot 1 written
    assert torch.equal(after[:, :1], before[:, :1])


# ---- the engine against generate ----

@pytest.mark.parametrize("slots", [1, 2, 4])
def test_engine_bitwise_parity_with_generate(model, slots):
    reqs, refs = _requests(), _refs(model)
    eng = _engine(model, slots)
    eng.run_to_completion(reqs)
    for req, ref in zip(reqs, refs):
        assert req.state == "done"
        assert req.tokens == ref     # token for token, not approximately
    assert eng.served == len(reqs)
    assert eng.free_slots == slots


def test_engine_parity_under_staggered_admission(model):
    """Requests admitted mid-flight of others still sample their exact
    generate() tokens — slot interleave is invisible to a request."""
    reqs, refs = _requests(), _refs(model)
    eng = _engine(model, 2)
    assert eng.admit(reqs[0]) and eng.admit(reqs[1])
    for _ in range(3):
        eng.step()
    eng.run_to_completion(reqs[2:])
    while eng.active_count:
        eng.step()
    assert [r.tokens for r in reqs] == refs


@pytest.mark.parametrize("slots", [1, 3])
def test_engine_greedy_streams_equal_the_jax_engine(params, model, slots):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (4, 9, 6, 13)]
    n_new = [12, 5, 9, 1]
    mine = [Request(prompt=p, n_new=n, temperature=0.0, seed=i)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    theirs = [jax_engine.Request(prompt=p, n_new=n, temperature=0.0, seed=i)
              for i, (p, n) in enumerate(zip(prompts, n_new))]
    _engine(model, slots).run_to_completion(mine)
    _jax_engine(params, slots).run_to_completion(theirs)
    assert [r.tokens for r in mine] == [r.tokens for r in theirs]
    assert all(r.state == "done" for r in mine)


def test_engine_leaves_grad_mode_off_on_a_thread(model):
    """Grad mode is per thread: a tick on a thread without no_grad must
    not build a graph (the cache would keep one a token)."""
    eng = _engine(model, 2)
    seen = []

    def drive():
        assert torch.is_grad_enabled()
        eng.admit(Request(prompt=np.ones(4, np.int32), n_new=3))
        eng.step()
        seen.append(eng._cache.blocks[0].k.requires_grad)

    t = threading.Thread(target=drive)
    t.start()
    t.join()
    assert seen == [False]


def test_engine_validation_errors(params, model):
    eng, jeng = _engine(model, 1), _jax_engine(params, 1)
    bad = [
        (dict(prompt=np.zeros(0, np.int32), n_new=4), "non-empty"),
        (dict(prompt=np.ones(4, np.int32), n_new=0), "n_new"),
        (dict(prompt=np.ones(4, np.int32), n_new=4, top_k=-1), "top_k"),
        (dict(prompt=np.ones(4, np.int32), n_new=4, temperature=-0.5),
         "temperature"),
        (dict(prompt=np.asarray([V + 3], np.int32), n_new=4), "vocabulary"),
        (dict(prompt=np.asarray([-2], np.int32), n_new=4), ">= 0"),
        (dict(prompt=np.ones(S, np.int32), n_new=4), "cache length"),
    ]
    for kw, needle in bad:
        msgs = []
        for e, cls in ((eng, Request), (jeng, jax_engine.Request)):
            with pytest.raises(ValueError, match=needle) as err:
                e.admit(cls(**kw))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert eng.active_count == 0


def test_engine_admit_false_when_full(model):
    eng = _engine(model, 1)
    a = Request(prompt=np.ones(4, np.int32), n_new=8)
    b = Request(prompt=np.ones(4, np.int32), n_new=8)
    assert eng.admit(a)
    assert not eng.admit(b)          # no free slot; not an error
    while eng.active_count:
        eng.step()
    assert eng.admit(b)


def test_engine_constructor_checks(model):
    with pytest.raises(ValueError, match="slots"):
        ServingEngine(model, slots=0)
    with pytest.raises(ValueError, match="positional table"):
        ServingEngine(model, slots=1, cache_len=S + 1)
    eng = ServingEngine(model, slots=3, cache_len=40)
    assert eng.cache_bytes == L * 2 * 3 * H * 40 * (D // H) * 4


# ---- the admission queue ----

def _queue_script(mod, req_cls):
    """The JAX test's backpressure/shed sequence on a manual clock; every
    observable of each step."""
    t = [0.0]
    q = mod.AdmissionQueue(2, clock=lambda: t[0])
    r1 = req_cls(prompt=np.ones(2, np.int32), n_new=2)
    r2 = req_cls(prompt=np.ones(2, np.int32), n_new=2, deadline_t=5.0)
    r3 = req_cls(prompt=np.ones(2, np.int32), n_new=2)
    r4 = req_cls(prompt=np.ones(2, np.int32), n_new=2, deadline_t=12.0)
    out = [q.submit(r1), q.submit(r2), q.submit(r3), r3.state, r3.wait(0)]
    t[0] = 10.0                      # r2's deadline passes while queued
    out += [q.take() is r1, q.take() is None, r2.state, r2.error,
            q.depth(), q.submit(r4)]
    t[0] = 13.0
    out += [q.reap(), r4.state, q.close("draining"),
            q.submit(req_cls(prompt=np.ones(2, np.int32), n_new=2))]
    q.reopen()
    out += [q.closed, q.submitted, q.rejected_full, q.rejected_closed,
            q.shed_deadline, q.taken]
    return out


def test_queue_backpressure_and_deadline_shed():
    out = _queue_script(port_queue, Request)
    assert out[:3] == [True, True, False]
    assert out[3] == "rejected" and out[4]
    assert out[5] and out[6] and out[7] == "shed"
    assert out == _queue_script(jax_queue, jax_engine.Request)


def test_serve_loop_drains_queue(model):
    eng = _engine(model, 2)
    q = AdmissionQueue(8)
    reqs = make_requests(5, prompt_len=6, n_new=5, vocab=V, seed=0)
    for r in reqs:
        q.submit(r)
    stop = threading.Event()
    thread = threading.Thread(target=serve_loop, args=(eng, q),
                              kwargs=dict(reload_s=0.0, stop=stop),
                              daemon=True)
    thread.start()
    try:
        for r in reqs:
            assert r.wait(60.0), "serve_loop did not resolve the request"
            assert r.state == "done" and len(r.tokens) == 5
    finally:
        stop.set()
        thread.join(timeout=10.0)


# ---- hot reload ----

def _lm_cfg(mod, tmp_path):
    return mod.TrainConfig(network="TransformerLM", lm_vocab=V, lm_d_model=D,
                           lm_layers=L, lm_heads=H, lm_seq_len=S,
                           train_dir=str(tmp_path))


def _template(cfg):
    staging, _ = lm_eval.build_lm_oracle(cfg)
    return staging, lm_eval.build_lm_template(cfg, staging)


def _save_port(cfg, step, params, corrupt=None):
    m = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                      max_seq_len=S)
    m.load_state_dict(convert.from_jax(params))
    tree = convert.state_to_jax(m, lm_eval.build_lm_template(cfg, m), step)
    path = ckpt.save_checkpoint(cfg.train_dir, step, tree,
                                config_json=cfg.to_json())
    if corrupt:
        corrupt_file(os.path.join(path, "state.msgpack"), corrupt)
    return path


def _save_jax(jcfg, step, params, corrupt=None):
    template = jax_lm_eval.build_lm_template(jcfg)
    path = jax_ckpt.save_checkpoint(jcfg.train_dir, step,
                                    template.replace(params=params),
                                    config_json=jcfg.to_json())
    if corrupt:
        corrupt_file(os.path.join(path, "state.msgpack"), corrupt)
    return path


def _shifted(params, by):
    return jax.tree.map(lambda a: np.asarray(a) + np.float32(by), params)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hot_reload_mid_stream_skips_corrupt_newest(params, model, tmp_path,
                                                    writer):
    """Mid-stream reload: the watcher picks the newest VALID checkpoint
    (the corrupt newest walked past and counted once), the engine copies
    the weights in between ticks, and the in-flight request completes with
    its pre-reload prefix the OLD weights' decode. The checkpoints are
    written by the port or by the JAX package."""
    cfg = _lm_cfg(config, tmp_path)
    save = _save_port if writer == "port" else (
        lambda c, *a, **k: _save_jax(_lm_cfg(jax_config, tmp_path), *a, **k))
    save(cfg, 1, params)
    served = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                           max_seq_len=S)
    served.load_state_dict(model.state_dict())
    eng = _engine(served, 2, model_step=1)
    weights = [t.data_ptr() for t in served.state_dict().values()]
    watcher = CheckpointWatcher(cfg.train_dir, _template(cfg),
                                migrate=migrate_packed_qkv, start_step=1)
    assert watcher.poll() is None    # nothing newer yet

    prompt = np.arange(4, dtype=np.int32) % V
    req = Request(prompt=prompt, n_new=20, temperature=0.7, top_k=9, seed=5)
    eng.admit(req)
    for _ in range(5):
        eng.step()
    prefix = list(req.tokens)        # sampled under the old weights

    # Training commits step 3 (other weights) and a CORRUPT step 5.
    params_b = _shifted(params, 0.25)
    save(cfg, 3, params_b)
    save(cfg, 5, params_b, corrupt="flip")

    got = watcher.poll()
    assert got is not None and got.step == 3
    assert watcher.skipped_corrupt == 1
    eng.set_params(got.params, step=got.step)
    assert eng.model_step == 3
    # Copied into the existing tensors, nothing reallocated.
    assert [t.data_ptr() for t in served.state_dict().values()] == weights
    want_b = convert.from_jax(params_b)
    for k, t in served.state_dict().items():
        assert torch.equal(t, want_b[k])

    while eng.active_count:
        eng.step()
    assert req.state == "done" and len(req.tokens) == 20
    ref = generate(model, prompt[None], n_new=20, temperature=0.7, top_k=9,
                   seed=5)[0, len(prompt):].tolist()
    assert ref[:len(prefix)] == prefix
    assert req.tokens != ref        # the weights did change mid-stream
    assert watcher.poll() is None    # step 5 stays corrupt; no re-offer
    assert watcher.skipped_corrupt == 1


def test_watcher_all_corrupt_keeps_serving(params, tmp_path):
    cfg = _lm_cfg(config, tmp_path)
    _save_port(cfg, 2, params, corrupt="truncate")
    watcher = CheckpointWatcher(cfg.train_dir, _template(cfg), start_step=1)
    assert watcher.poll() is None
    assert watcher.skipped_corrupt == 1 and watcher.reloads == 0
    assert watcher.poll() is None and watcher.skipped_corrupt == 1


def test_set_params_from_another_thread_lands_on_the_loop(model):
    """/admin/reload's path: a set_params from a thread that is not the
    serve loop's hands the weights over and returns once the loop has
    copied them in."""
    served = TransformerLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H,
                           max_seq_len=S)
    served.load_state_dict(model.state_dict())
    eng = _engine(served, 2, model_step=1)
    q = AdmissionQueue(4)
    stop = threading.Event()
    loop = threading.Thread(target=serve_loop, args=(eng, q),
                            kwargs=dict(reload_s=0.0, stop=stop), daemon=True)
    loop.start()
    try:
        new = {k: v + 1.0 for k, v in model.state_dict().items()}
        eng.set_params(new, step=2)
        assert eng.model_step == 2 and eng._loop_thread is loop
        assert torch.equal(served.lm_head.weight, new["lm_head.weight"])
        with pytest.raises(ValueError, match="model"):
            eng.set_params({"lm_head.weight": new["lm_head.weight"]})
    finally:
        stop.set()
        loop.join(timeout=10.0)


# ---- HTTP front-end ----

def _call(url, path, body=None, raw=None, headers=None):
    """(status, JSON body) of one request; ``raw`` sends bytes as they
    are, ``headers`` replaces the default ones."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        if body is None and raw is None:
            conn.request("GET", path)
        else:
            data = raw if raw is not None else json.dumps(body).encode()
            hdrs = headers if headers is not None else {
                "Content-Type": "application/json",
                "Content-Length": str(len(data))}
            conn.putrequest("POST", path)
            for k, v in hdrs.items():
                conn.putheader(k, v)
            conn.endheaders(data)
        resp = conn.getresponse()
        payload = resp.read()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, (json.loads(payload) if "json" in ctype
                             else payload.decode())
    finally:
        conn.close()


_HTTP_CASES = [
    ("generate", "/v1/generate", dict(body={"tokens": [0, 1, 2, 3, 4],
                                            "n_new": 6, "temperature": 0.0,
                                            "seed": 2})),
    ("n_new 0", "/v1/generate", dict(body={"tokens": [1, 2], "n_new": 0})),
    ("no prompt", "/v1/generate", dict(body={"nonsense": 1})),
    ("bad tokens", "/v1/generate", dict(body={"tokens": [1, "x"]})),
    ("bad field", "/v1/generate", dict(body={"tokens": [1], "n_new": "x"})),
    ("out of vocabulary", "/v1/generate", dict(body={"tokens": [V + 1]})),
    ("bad JSON", "/v1/generate", dict(raw=b"{nope")),
    ("bad length", "/v1/generate", dict(raw=b"{}", headers={
        "Content-Length": "abc"})),
    ("no length", "/v1/generate", dict(raw=b"", headers={})),
    ("oversize", "/v1/generate", dict(raw=b"x" * 300)),
    ("deadline", "/v1/generate", dict(body={"tokens": [1, 2], "n_new": 4,
                                            "deadline_s": 1e-9})),
    ("healthz", "/healthz", {}), ("readyz", "/readyz", {}),
    ("stats", "/stats", {}), ("metrics", "/metrics", {}),
    ("slo off", "/slo", {}), ("trace off", "/debug/requests", {}),
    ("no route", "/nope", {}),
    ("drain", "/admin/drain", dict(body={})),
    ("draining", "/v1/generate", dict(body={"tokens": [1, 2], "n_new": 2})),
    ("readyz draining", "/readyz", {}),
    ("resume", "/admin/resume", dict(body={})),
    ("reload without watcher", "/admin/reload", dict(body={})),
]


def _http_run(frontend):
    out = {}
    with frontend as fe:
        for name, path, kw in _HTTP_CASES:
            if name == "oversize":
                fe.max_body_bytes = 256
            out[name] = _call(fe.url, path, **kw)
            fe.max_body_bytes = 1 << 20
    return out


def _shape(obj):
    """Keys (recursively) and types: what the JAX package's body looks
    like, without its values."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_http_status_codes_and_bodies_equal_jax(params, model):
    registry = declare_serving_metrics(Registry())
    jreg = jax_registry.declare_serving_metrics(jax_registry.Registry())
    mine = _http_run(ServingFrontend(
        _engine(model, 2, model_step=7, registry=registry), port=0,
        max_queue=4))
    theirs = _http_run(jax_server.ServingFrontend(
        _jax_engine(params, 2, model_step=7, registry=jreg), port=0,
        max_queue=4))
    codes = {k: v[0] for k, v in mine.items()}
    assert codes["generate"] == 200 and codes["n_new 0"] == 400
    assert codes["oversize"] == 413 and codes["deadline"] == 504
    assert codes["draining"] == 503 and codes["readyz draining"] == 503
    assert codes == {k: v[0] for k, v in theirs.items()}
    for name, (_, body) in mine.items():
        want = theirs[name][1]
        if name == "generate":
            assert body["tokens"] == want["tokens"]      # greedy, same weights
        assert _shape(body) == _shape(want), name
        if isinstance(body, dict) and "error" in body:
            assert body["error"] == want["error"], name


def test_http_roundtrip(model):
    registry = declare_serving_metrics(Registry())
    eng = _engine(model, 2, model_step=7, registry=registry)
    prompt = np.arange(5, dtype=np.int32).tolist()
    ref = generate(model, np.asarray(prompt)[None], n_new=6,
                   temperature=0.8, top_k=7, seed=2)[0, 5:].tolist()
    with ServingFrontend(eng, port=0, max_queue=4) as fe:
        code, out = _call(fe.url, "/v1/generate", body={
            "tokens": prompt, "n_new": 6, "temperature": 0.8, "top_k": 7,
            "seed": 2})
        assert code == 200
        assert out["tokens"] == ref          # parity through the full stack
        assert out["model_step"] == 7
        assert out["ttft_ms"] >= 0 and out["latency_ms"] >= out["ttft_ms"]
        code, health = _call(fe.url, "/healthz")
        assert health["ok"] and health["model_step"] == 7
        code, stats = _call(fe.url, "/stats")
        assert stats["served"] >= 1 and stats["slots"] == 2
        assert stats["metrics"]["serve_requests"] >= 1
        assert stats["metrics"]["serve_request_latency_s"]["count"] >= 1
        code, text = _call(fe.url, "/metrics")
        assert code == 200 and "serve_requests_total 1" in text


# ---- load generator ----

def test_loadgen_closed_loop_stats(model):
    eng = _engine(model, 4)
    reqs = make_requests(6, prompt_len=8, n_new=6, vocab=V, seed=1)
    stats = run_closed_loop(eng, reqs)
    assert stats["completed"] == 6 and stats["tokens"] == 36
    assert stats["tokens_per_sec"] > 0
    for k in ("ttft_p50_ms", "ttft_p99_ms", "latency_p50_ms",
              "latency_p99_ms"):
        assert stats[k] >= 0
    assert stats["ttft_p50_ms"] <= stats["latency_p99_ms"]


def test_loadgen_deterministic_across_slot_counts(model):
    tok = []
    for slots in (1, 3):
        eng = _engine(model, slots)
        reqs = make_requests(4, prompt_len=6, n_new=8, vocab=V, seed=2)
        run_closed_loop(eng, reqs)
        tok.append([r.tokens for r in reqs])
    assert tok[0] == tok[1]


def test_summarize_counts_non_done_states():
    done = Request(prompt=np.ones(2, np.int32), n_new=2)
    done.state, done.tokens = "done", [1, 2]
    done.t_submit, done.t_first, done.t_done = 0.0, 0.1, 0.2
    shed = Request(prompt=np.ones(2, np.int32), n_new=2)
    shed.state = "shed"
    out = summarize([done, shed], wall_s=1.0)
    assert out["completed"] == 1 and out["shed"] == 1
    assert out["tokens"] == 2 and out["tokens_per_sec"] == 2.0


def test_loadgen_open_loop(model):
    """Poisson arrivals through the queue + serve_loop thread: every
    request resolves, latency stats materialize, shedding stays sane."""
    eng = _engine(model, 4)
    reqs = make_requests(12, prompt_len=6, n_new=8, vocab=V, seed=3)
    stats = run_open_loop(eng, reqs, rate_rps=200.0, max_queue=16,
                          deadline_s=60.0)
    assert stats["completed"] + stats["shed"] + stats["rejected"] == 12
    assert stats["completed"] >= 1
    assert stats["failed"] == 0
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"]


# ---- generate() edge validation (the CLI) ----

def test_generate_cli_rejects_bad_n_new_and_top_k(tmp_path):
    for flags in (["--n-new", "0"], ["--top-k", "-1"]):
        with pytest.raises(SystemExit):
            generate_cli.main(["--train-dir", str(tmp_path), "--prompt", "hi",
                               "--device", "cpu"] + flags)


# ---- serve config knobs ----

@pytest.mark.parametrize("kw", [
    dict(serve_slots=0), dict(serve_max_queue=0), dict(serve_max_new=0),
    dict(serve_deadline_s=0.0), dict(serve_reload_s=-1.0),
    dict(serve_port=-1), dict(serve_max_body_bytes=0),
    dict(serve_replica_id=-1), dict(reqtrace_keep=-1),
    dict(reqtrace_sample=2.0), dict(slo_spec="ttft_p99<0ms"),
    dict(slo_spec="bogus_p99<1s"), dict(fault_spec="replica_kill:r=0")])
def test_serve_config_validation_equals_jax(kw):
    msgs = []
    for mod in (config, jax_config):
        with pytest.raises(ValueError) as e:
            mod.TrainConfig(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [
    dict(serve_slots=4, serve_max_queue=2, serve_reload_s=0.0,
         serve_port=0, serve_host="0.0.0.0", serve_deadline_s=5.0,
         serve_max_new=3, slo_spec="ttft_p99<100ms;availability>=99.5",
         reqtrace_keep=0, reqtrace_sample=1.0, serve_max_body_bytes=9,
         serve_kv_dir="/tmp/kv", serve_fleet="v", serve_replica_id=2,
         serve_advertise="10.0.0.1"),
    dict(fault_spec="replica_kill:served=20,r=1"),
    dict(network="TransformerLM", fault_spec="replica_kill:served=3"),
    dict(mode="kofn", serve_slots=2, fault_spec="replica_kill:served=5"),
    dict(mode="async", fault_spec="replica_kill:served=2,r=1")])
def test_serve_config_accepts_what_jax_accepts(kw):
    jax_config.TrainConfig(**kw)
    got = config.TrainConfig(**kw)
    assert all(getattr(got, k) == v for k, v in kw.items())
    assert config.TrainConfig().serve_slots == 8


# ---- telemetry ----

def test_serving_and_router_metrics_declared_like_jax():
    from ps_pytorch_tpu_torch import telemetry
    for name in ("SERVING_COUNTERS", "SERVING_GAUGES", "SERVING_HISTOGRAMS",
                 "ROUTER_COUNTERS", "ROUTER_GAUGES", "ROUTER_HISTOGRAMS"):
        assert getattr(telemetry, name) == getattr(jax_registry, name)
    mine = telemetry.declare_router_metrics(
        telemetry.declare_serving_metrics(Registry()))
    theirs = jax_registry.declare_router_metrics(
        jax_registry.declare_serving_metrics(jax_registry.Registry()))
    assert {k: (s.kind, s.unit, s.buckets) for k, s in mine.specs().items()} \
        == {k: (s.kind, s.unit, s.buckets) for k, s in theirs.specs().items()}


def test_registry_histogram():
    reg = Registry()
    reg.histogram("lat", unit="s", buckets=(0.1, 1.0, 10.0))
    assert reg.hist_summary("lat")["count"] == 0
    for v in (0.05, 0.2, 0.3, 0.5, 5.0):
        reg.observe("lat", v)
    s = reg.hist_summary("lat")
    assert s["count"] == 5 and s["min"] == 0.05 and s["max"] == 5.0
    assert abs(s["sum"] - 6.05) < 1e-9
    assert 0.05 <= s["p50"] <= 1.0       # median falls in the (0.1, 1] bucket
    assert 1.0 <= s["p99"] <= 5.0        # p99 lands in the top bucket
    with pytest.raises(TypeError):
        reg.inc("lat")                   # histogram is not a counter
    with pytest.raises(KeyError):
        reg.observe("nope", 1.0)
    assert reg.snapshot()["lat"]["count"] == 5


def test_registry_histogram_bad_buckets():
    with pytest.raises(ValueError, match="ascending"):
        Registry().histogram("h", buckets=(1.0, 0.5))


def test_declare_serving_metrics_idempotent():
    reg = declare_serving_metrics(Registry())
    declare_serving_metrics(reg)         # re-declare identical: fine
    reg.inc("serve_tokens", 3)
    reg.set("serve_active_slots", 2)
    reg.observe("serve_ttft_s", 0.01)
    snap = reg.snapshot()
    assert snap["serve_tokens"] == 3.0
    assert snap["serve_ttft_s"]["count"] == 1


# ---- the entry point ----

def _launch(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2", **(env_extra or {}))
    return subprocess.Popen([sys.executable, *args], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_serve_entry_point_first_line_and_sigterm(params, tmp_path):
    """``python -m ps_pytorch_tpu_torch.serve --device cpu`` and the root
    ``serve.py`` on the same checkpoint: the first JSON lines have the
    same keys (and values, the URL aside), a request answers the greedy
    tokens of the JAX engine, and SIGTERM drains and exits 0."""
    cfg = _lm_cfg(config, tmp_path / "td")
    _save_port(cfg, 4, params)
    common = ["--train-dir", cfg.train_dir, "--serve-port", "0",
              "--serve-slots", "2", "--slo-spec", "ttft_p99<30s"]
    procs = {"port": _launch(["-m", "ps_pytorch_tpu_torch.serve", *common,
                              "--device", "cpu"]),
             "jax": _launch(["serve.py", *common])}
    firsts, outs = {}, {}
    try:
        for name, proc in procs.items():
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            firsts[name] = json.loads(line)
        for name, first in firsts.items():
            outs[name] = _call(first["serving"], "/v1/generate", body={
                "tokens": [3, 1, 4, 1, 5], "n_new": 8, "temperature": 0.0})
    finally:
        for proc in procs.values():
            proc.send_signal(signal.SIGTERM)
        rcs = {name: proc.wait(timeout=60) for name, proc in procs.items()}
    assert rcs == {"port": 0, "jax": 0}
    mine, theirs = firsts["port"], firsts["jax"]
    assert list(mine) == list(theirs)
    for k in ("serving", "metrics"):
        mine.pop(k), theirs.pop(k)
    assert mine == theirs and mine["model_step"] == 4
    assert outs["port"][0] == outs["jax"][0] == 200
    assert outs["port"][1]["tokens"] == outs["jax"][1]["tokens"]


def test_serve_entry_point_refuses_no_card_and_other_models(params,
                                                            tmp_path):
    from ps_pytorch_tpu_torch import serve
    cfg = _lm_cfg(config, tmp_path / "td")
    _save_port(cfg, 2, params)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            serve.main(["--train-dir", cfg.train_dir, "--serve-port", "0"])
        assert e.value.code == 2
    moe = tmp_path / "moe"
    ckpt.save_checkpoint(str(moe), 1, {"step": 1}, config_json=json.dumps(
        {"network": "MoETransformerLM"}))
    for args in (["--train-dir", str(moe)],
                 ["--train-dir", str(tmp_path / "empty")]):
        with pytest.raises(SystemExit) as e:
            serve.main([*args, "--serve-port", "0", "--device", "cpu"])
        assert e.value.code == 2
