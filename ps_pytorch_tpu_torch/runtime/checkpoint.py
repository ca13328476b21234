"""Step-named checkpoints with atomic commit and resume: the JAX package's
``runtime/checkpoint.py`` contract, in the same layout, so either package
reads what the other writes.

``train_dir/model_step_<k>/`` holds ``state.msgpack`` (the training state
as flax's msgpack bytes, ``runtime/msgpack_io.py``), ``config.json``,
``meta.json`` (``{"step": k, "compressed": false}``), an optional
``extra_state.msgpack`` and ``manifest.json`` with the SHA-256 of each file. The write goes into a pid-suffixed
``.tmp_<k>_<pid>``, manifest included, and commits with ``os.rename``: a
polling evaluator never sees a half-written checkpoint, and a committed one
is always verifiable. ``latest_valid_step`` and ``load_latest_valid`` walk
back past a torn or bit-rotted checkpoint to the newest one that verifies.

The state is a nested dict of numpy arrays (``models.convert.state_to_jax``);
loading returns the same (``state_from_jax`` puts it into a model).

``compress=True`` wraps the serialized bytes in the ``PSC1`` container of
``compression/`` (the checkpoint leg of ``--compress-grad``) and says so in
``meta.json``. ``extra_state`` is an auxiliary tree (error-feedback
residuals, say) committed beside the model as ``extra_state.msgpack``: same
atomic rename, same manifest coverage, read back by ``load_extra_state``.
"""

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ps_pytorch_tpu_torch.compression import w_compress, w_decompress
from ps_pytorch_tpu_torch.runtime import msgpack_io
from ps_pytorch_tpu_torch.telemetry.trace import span as _span

_STEP_RE = re.compile(r"^model_step_(\d+)$")
_MANIFEST = "manifest.json"


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed verification (missing file, SHA-256
    mismatch, unreadable manifest)."""


def checkpoint_path(train_dir: str, step: int) -> str:
    return os.path.join(train_dir, f"model_step_{step}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _as_device_get(tree: Any) -> Any:
    """A tree of dicts as ``jax.device_get`` hands it to flax in the JAX
    package's save: every dict with sorted keys, numpy scalars as 0-d
    arrays."""
    if isinstance(tree, dict):
        return {k: _as_device_get(tree[k]) for k in sorted(tree)}
    return np.asarray(tree) if isinstance(tree, np.generic) else tree


def save_checkpoint(train_dir: str, step: int, state: Any,
                    config_json: str = "{}", compress: bool = False,
                    codec_level: int = 3, extra_meta: Optional[dict] = None,
                    extra_state: Optional[Any] = None) -> str:
    """Atomically write train_dir/model_step_<step>. Returns the final
    path. ``extra_meta``: keys added to ``meta.json`` (the leadership
    epoch that committed the weights). Recorded as the ambient span
    ``checkpoint_write``."""
    with _span("checkpoint_write", step=step):
        return _save_checkpoint(train_dir, step, state, config_json,
                                compress, codec_level, extra_meta,
                                extra_state)


def _save_checkpoint(train_dir: str, step: int, state: Any,
                     config_json: str, compress: bool, codec_level: int,
                     extra_meta: Optional[dict],
                     extra_state: Optional[Any]) -> str:
    os.makedirs(train_dir, exist_ok=True)
    blob = msgpack_io.packb(state)
    meta = {"step": step, "compressed": bool(compress), **(extra_meta or {})}
    if compress:
        blob = w_compress(np.frombuffer(blob, np.uint8), level=codec_level)
    # A restarted writer must not collide with a crashed predecessor's
    # tmp: sweep this step's stale tmps, then write under our pid.
    for name in os.listdir(train_dir):
        if name.startswith(f".tmp_{step}_"):
            shutil.rmtree(os.path.join(train_dir, name), ignore_errors=True)
    tmp = os.path.join(train_dir, f".tmp_{step}_{os.getpid()}")
    final = checkpoint_path(train_dir, step)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
        f.write(blob)
    with open(os.path.join(tmp, "config.json"), "w") as f:
        f.write(config_json)
    if extra_state is not None:
        with open(os.path.join(tmp, "extra_state.msgpack"), "wb") as f:
            f.write(msgpack_io.packb(_as_device_get(extra_state)))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    manifest = {"step": step, "algo": "sha256",
                "files": {name: _sha256_file(os.path.join(tmp, name))
                          for name in sorted(os.listdir(tmp))}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):           # the last writer wins
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _check_manifest(path: str) -> None:
    """Raise CheckpointCorruptError on any integrity violation; a
    checkpoint written before manifests existed passes."""
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        return
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}")
    for name, digest in files.items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise CheckpointCorruptError(f"{path}: missing {name}")
        got = _sha256_file(fpath)
        if got != digest:
            raise CheckpointCorruptError(
                f"{path}: {name} sha256 mismatch "
                f"(manifest {digest[:12]}…, file {got[:12]}…)")


def verify_checkpoint(train_dir: str, step: int) -> bool:
    """True iff model_step_<step> verifies: every manifest entry exists
    with its SHA-256 (a manifest-less checkpoint: its three files exist)."""
    path = checkpoint_path(train_dir, step)
    if not os.path.isdir(path):
        return False
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        return all(os.path.exists(os.path.join(path, n))
                   for n in ("state.msgpack", "meta.json", "config.json"))
    try:
        _check_manifest(path)
    except CheckpointCorruptError:
        return False
    return True


def load_checkpoint(train_dir: str, step: int,
                    restore: Optional[Callable[[dict], Any]] = None
                    ) -> Tuple[Any, dict, str]:
    """-> (state, meta, config_json). ``state`` is the stored tree, or what
    ``restore(tree)`` returns (it puts the tree into a model and raises
    when the tree does not fit). Recorded as the ambient span
    ``checkpoint_load``."""
    with _span("checkpoint_load", step=step):
        return _load_checkpoint(train_dir, step, restore)


def _load_checkpoint(train_dir: str, step: int,
                     restore: Optional[Callable[[dict], Any]]
                     ) -> Tuple[Any, dict, str]:
    path = checkpoint_path(train_dir, step)
    _check_manifest(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        blob = f.read()
    if meta.get("compressed"):
        blob = w_decompress(blob).tobytes()
    tree = msgpack_io.unpackb(blob)
    with open(os.path.join(path, "config.json")) as f:
        config_json = f.read()
    return (restore(tree) if restore else tree), meta, config_json


def load_extra_state(train_dir: str, step: int) -> Optional[Any]:
    """The auxiliary tree that ``save_checkpoint(..., extra_state=...)``
    committed at ``step``, or None when that checkpoint carries none. It is
    checked against the manifest like the main payload."""
    path = checkpoint_path(train_dir, step)
    fpath = os.path.join(path, "extra_state.msgpack")
    if not os.path.exists(fpath):
        return None
    _check_manifest(path)
    with open(fpath, "rb") as f:
        return msgpack_io.unpackb(f.read())


def committed_steps(train_dir: str) -> List[int]:
    """All committed steps, ascending (committed is not yet valid)."""
    if not os.path.isdir(train_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(train_dir)
                  if (m := _STEP_RE.match(name)))


def latest_step(train_dir: str) -> Optional[int]:
    """Largest k with a committed model_step_<k>, or None."""
    steps = committed_steps(train_dir)
    return steps[-1] if steps else None


def latest_valid_step(train_dir: str) -> Optional[int]:
    """Largest k whose checkpoint verifies, skipping corrupt ones."""
    for step in reversed(committed_steps(train_dir)):
        if verify_checkpoint(train_dir, step):
            return step
    return None


def load_latest_valid(train_dir: str,
                      restore: Optional[Callable[[dict], Any]] = None
                      ) -> Optional[Tuple[Any, dict, str, int]]:
    """Restore the newest checkpoint that verifies AND restores, walking
    back past corrupt ones -> (state, meta, config_json, step), or None
    when there is none. A step that fails for another reason than
    corruption (another model, say) fails on every older step too: if no
    step restores, the newest such error is raised rather than training
    from scratch."""
    first_err: Optional[Exception] = None
    for step in reversed(committed_steps(train_dir)):
        if not verify_checkpoint(train_dir, step):
            print(f"[ckpt] step {step} failed verification; "
                  f"falling back to an older checkpoint")
            continue
        try:
            state, meta, config_json = load_checkpoint(train_dir, step,
                                                       restore)
            return state, meta, config_json, step
        except CheckpointCorruptError as e:
            print(f"[ckpt] step {step} corrupt on load ({e}); falling back")
        except (ValueError, KeyError, OSError) as e:
            if first_err is None:
                first_err = e
            print(f"[ckpt] step {step} unrestorable "
                  f"({type(e).__name__}: {e}); falling back")
    if first_err is not None:
        raise first_err
    return None


def prune_checkpoints(train_dir: str, keep_last: int) -> List[int]:
    """Remove all but the newest ``keep_last`` committed checkpoints.
    Returns the removed steps."""
    if keep_last <= 0:
        return []
    drop = committed_steps(train_dir)[:-keep_last]
    for step in drop:
        shutil.rmtree(checkpoint_path(train_dir, step), ignore_errors=True)
    return drop


def wait_for_step(train_dir: str, step: int, poll_s: float = 10.0,
                  timeout_s: Optional[float] = None) -> bool:
    """Block until model_step_<step> exists; False after ``timeout_s``."""
    waited = 0.0
    while not os.path.isdir(checkpoint_path(train_dir, step)):
        if timeout_s is not None and waited >= timeout_s:
            return False
        time.sleep(poll_s)
        waited += poll_s
    return True
