"""Token-stream data for LM training: a copy of the JAX package's
``data/text.py`` (the port imports nothing of that package). Batches are
byte-equal to the JAX loader's (``tests/test_torch_lm.py``).

``synthetic_tokens`` is a learnable corpus: a Markov chain over ``vocab``
tokens with a strong transition structure, so next-token loss falls well
below the uniform floor log(vocab). ``tokens_from_file`` is byte-level real
data from any local file. ``TokenLoader`` cuts contiguous [B, S] windows in
a shared-seed shuffled order.
"""

from typing import Iterator, Tuple

import numpy as np


def synthetic_tokens(n_tokens: int, vocab: int = 256,
                     seed: int = 0) -> np.ndarray:
    """Markov stream: from state t, next token is (t + step) % vocab with
    step drawn from a tiny per-state table — highly predictable (entropy
    << log vocab) yet not constant."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, size=vocab)        # per-state jump table
    noise = rng.random(n_tokens) < 0.05           # 5% uniform glitches
    glitch = rng.integers(0, vocab, size=n_tokens)
    out = np.empty(n_tokens, np.int32)
    t = int(rng.integers(0, vocab))
    for i in range(n_tokens):
        t = int(glitch[i]) if noise[i] else (t + int(steps[t])) % vocab
        out[i] = t
    return out


def tokens_from_file(path: str, vocab: int = 256,
                     max_tokens: int = 0) -> np.ndarray:
    """Byte-level tokenization of any local file: REAL corpus data with no
    network and no tokenizer — each byte is a token (so ``vocab`` must be
    >= 256; a larger vocab just leaves ids 256+ unused). This is the LM
    counterpart of the image pipeline's bundled-real-dataset fallback
    (data/datasets.py Digits): the real-data oracle works in zero-egress
    environments, e.g. on a source tree or any text dump.

    max_tokens > 0 truncates (bounds memory for huge files)."""
    if vocab < 256:
        raise ValueError(f"byte-level corpus needs vocab >= 256, got {vocab}")
    # count bounds the READ itself — slicing after a full np.fromfile would
    # materialize a huge file before truncating.
    data = np.fromfile(path, dtype=np.uint8,
                       count=max_tokens if max_tokens else -1)
    if len(data) == 0:
        raise ValueError(f"{path} is empty")
    return data.astype(np.int32)


def lm_streams(cfg) -> Tuple[np.ndarray, np.ndarray]:
    """(train_tokens, val_tokens) for a TrainConfig — THE train/held-out
    split, shared by the LMTrainer and the standalone evaluator so both
    score the same tail. Corpus file (byte-level real data) when set, else
    the synthetic Markov stream."""
    if cfg.lm_corpus_file:
        stream = tokens_from_file(cfg.lm_corpus_file, cfg.lm_vocab,
                                  max_tokens=cfg.lm_corpus_tokens)
    else:
        stream = synthetic_tokens(cfg.lm_corpus_tokens, cfg.lm_vocab,
                                  seed=cfg.seed)
    # Held-out tail: last 10% of the stream never trains.
    cut = len(stream) - max(len(stream) // 10,
                            (cfg.batch_size + 1) * cfg.lm_seq_len + 1)
    if cut <= cfg.batch_size * cfg.lm_seq_len:
        # Without this, a too-small corpus surfaces as a confusing
        # "0 windows < global batch" TokenLoader error.
        need = (2 * cfg.batch_size + 1) * cfg.lm_seq_len + 2
        src = cfg.lm_corpus_file or "the synthetic stream"
        raise ValueError(
            f"corpus too small: {src} has {len(stream)} tokens but "
            f"batch_size={cfg.batch_size} x lm_seq_len={cfg.lm_seq_len} "
            f"plus the held-out tail needs roughly {need}")
    return stream[:cut], stream[cut:]


class TokenLoader:
    """Contiguous [B, S] windows over a token stream, shared-seed shuffled
    window order, per-host disjoint shards (the DataLoader discipline)."""

    def __init__(self, tokens: np.ndarray, batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 shuffle: bool = True):
        if batch % num_hosts:
            raise ValueError(f"batch {batch} not divisible by {num_hosts} hosts")
        self.tokens = tokens
        self.local_batch = batch // num_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id, self.num_hosts = host_id, num_hosts
        self.shuffle = shuffle
        n_windows = (len(tokens) - 1) // seq_len
        if n_windows < batch:
            raise ValueError(f"{len(tokens)} tokens give {n_windows} windows "
                             f"< global batch {batch}")
        self.shard_windows = n_windows // num_hosts
        self._epoch = 0
        self._cursor = 0

    def __len__(self) -> int:
        return self.shard_windows // self.local_batch

    def _order(self, epoch: int) -> np.ndarray:
        n_windows = (len(self.tokens) - 1) // self.seq_len
        idx = np.arange(n_windows)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        lo = self.host_id * self.shard_windows
        return idx[lo:lo + self.shard_windows]

    def _gather(self, sel: np.ndarray) -> np.ndarray:
        """Window ids -> [len(sel), seq_len] int32 (the one place window
        framing lives, shared by next_batch and epoch)."""
        out = np.empty((len(sel), self.seq_len), np.int32)
        for i, w in enumerate(sel):
            out[i] = self.tokens[w * self.seq_len:(w + 1) * self.seq_len]
        return out

    def next_batch(self) -> np.ndarray:
        """-> [local_batch, seq_len] int32; advances epochs forever."""
        if self._cursor + self.local_batch > self.shard_windows:
            self._epoch += 1
            self._cursor = 0
        order = self._order(self._epoch)
        sel = order[self._cursor:self._cursor + self.local_batch]
        self._cursor += self.local_batch
        return self._gather(sel)

    def epoch(self, epoch: int) -> Iterator[np.ndarray]:
        order = self._order(epoch)
        for b in range(len(self)):
            yield self._gather(
                order[b * self.local_batch:(b + 1) * self.local_batch])
