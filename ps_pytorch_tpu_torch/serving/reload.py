"""Hot checkpoint reload for the serving engine: the JAX package's
``serving/reload.py``.

Same posture as the polling evaluator (``runtime/evaluator.py``): watch a
train dir, notice when training has committed a NEWER checkpoint, and load
it — but through ``load_latest_valid`` so a torn or bit-rotted newest
checkpoint is walked past instead of served (the corruption-fallback
contract of ``runtime/checkpoint.py``). The watcher only LOADS, on the
host, into a staging model of its own; the engine copies the weights in
between decode ticks (``ServingEngine.set_params``), so in-flight requests
keep streaming across a reload.
"""

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ps_pytorch_tpu_torch.models.convert import state_from_jax
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt


def restore_params(tree: dict, template: Any,
                   migrate=None) -> Dict[str, torch.Tensor]:
    """A checkpoint's tree -> the weights to serve, a ``state_dict`` of
    host tensors: the tree is restored into ``template`` (a staging
    ``TransformerLM`` and its optimizer state, or the model alone; see
    ``CheckpointWatcher``), which checks every name and shape; a tree that
    does not fit is rewritten by ``migrate`` and restored again when
    ``migrate`` changed something, as the JAX ``load_checkpoint(...,
    migrate=...)`` does."""
    model, opt_state = template if isinstance(template, tuple) \
        else (template, None)
    try:
        state_from_jax(tree, model, opt_state)
    except (ValueError, KeyError):
        if migrate is None:
            raise
        migrated, n_changed = migrate(tree)
        if not n_changed:
            raise
        state_from_jax(migrated, model, opt_state)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@dataclass
class ReloadResult:
    """What ``poll`` hands the drive loop when a newer valid checkpoint
    landed: the weights to serve (a ``state_dict`` on the host) and the
    step they came from."""
    step: int
    params: Dict[str, torch.Tensor]
    config_json: str
    meta: dict


class CheckpointWatcher:
    """Polls ``train_dir`` for newer VALID checkpoints.

    ``template`` is the training state the checkpoints restore into: a
    ``TransformerLM`` of the served geometry on the host (a staging copy,
    never the served model) and its optimizer state
    (``runtime/lm_eval.build_lm_template``), or the model alone (a tree
    whose optimizer state is not checked). ``migrate`` rewrites a tree of
    an older layout (``models/transformer.migrate_packed_qkv``) when the
    tree does not fit as it is; ``start_step`` marks the checkpoint
    already being served so the first poll doesn't re-load it."""

    def __init__(self, train_dir: str, template: Any, *, migrate=None,
                 start_step: int = -1):
        self.train_dir = train_dir
        self.template = template
        self.migrate = migrate
        self.loaded_step = int(start_step)
        self.reloads = 0
        self.skipped_corrupt = 0
        self.poll_count = 0
        # Newest step already counted into skipped_corrupt — a corrupt
        # newest checkpoint is ONE corruption event, not one per poll.
        self._skip_counted = -1
        # Meta of the newest loaded checkpoint — elastic training runs
        # stamp leader_epoch/leader_pid here, and /healthz surfaces which
        # leadership epoch produced the weights currently being served.
        self.last_meta: dict = {}
        # The serve loop's periodic poll and /admin/reload may poll at
        # once; they share the staging model.
        self._lock = threading.Lock()

    def poll(self) -> Optional[ReloadResult]:
        """None when nothing newer is loadable; otherwise load the newest
        valid checkpoint past ``loaded_step`` (counting any corrupt newer
        steps it had to walk past) and advance."""
        with self._lock:
            return self._poll()

    def _poll(self) -> Optional[ReloadResult]:
        self.poll_count += 1
        newest = ckpt.latest_step(self.train_dir)
        if newest is None or newest <= self.loaded_step:
            return None
        got = ckpt.load_latest_valid(self.train_dir, lambda tree:
                                     restore_params(tree, self.template,
                                                    self.migrate))
        if got is None:
            # Everything newer (indeed everything) is corrupt: keep serving
            # what we have. Count the newest step once, not every poll —
            # the counter tracks corruption EVENTS, and the same corrupt
            # newest re-observed is the same event.
            if newest != self._skip_counted:
                self.skipped_corrupt += 1
                self._skip_counted = newest
            return None
        params, meta, config_json, step = got
        if step < newest and newest != self._skip_counted:
            self.skipped_corrupt += 1
            self._skip_counted = newest
        if step <= self.loaded_step:
            return None     # newest valid is what we already serve
        self.loaded_step = step
        self.reloads += 1
        self.last_meta = dict(meta)
        return ReloadResult(step=step, params=params,
                            config_json=config_json, meta=meta)
