"""End-to-end gradient integrity: the JAX package's
``resilience/integrity.py``, its three layers.

- **Layer 1, wire digests** (``wire_digest`` / ``verify_digest``): every
  armoured chunk a channel publishes (``parallel/transport.py``) carries a
  CRC token in the version's meta, and readers verify each chunk before
  decode. A failed digest demotes that read to "absent this round", which
  the staleness machinery upstream already absorbs: counted, never a
  crash. The token is crc32c (Castagnoli) when the ``crc32c`` module
  imports, else zlib's crc32, the same rule as the JAX package's; the
  algorithm's name travels in the token, so a reader built with the other
  one skips the check instead of flagging every chunk.
- **Layer 2, the screen before the sum** (``validate_payload``,
  ``validate_float_leaf``, ``payload_norm``, ``contribution_norm``,
  ``mad_outliers``): a contribution is validated in the domain it arrived
  in (int8lat exponent bounds, topk/randk index range and order, finite
  float leaves), and a robust outlier gate over the contributors' norms
  (median absolute deviation, one-sided, a 4x-median floor, abstaining
  below 4 finite contributors) excludes one exploded replica instead of
  averaging it in.
- **Layer 3, quarantine** (``QuarantineManager``, ``GradIntegrity``):
  strikes per contributor; a repeat offender is quarantined (screened but
  never summed) and readmitted on probation after a streak of clean
  screens.

Payload dicts are numpy on the host, as in the JAX package. A float leaf
may also be a torch tensor on its device (the port's pools average on the
card): it is screened where it lies, ``isfinite`` and a float64 sum of
squares a leaf, with one host sync a contributor, and gives the JAX
package's verdicts, reasons and (to float64 rounding) norms. Nothing here
imports torch: a tensor is read through its own methods.
"""

import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

try:                                    # pragma: no cover - env dependent
    from crc32c import crc32c as _crc_impl
    _CRC_ALGO = "crc32c"
except ImportError:
    _crc_impl = zlib.crc32
    _CRC_ALGO = "crc32"


def wire_digest(data) -> str:
    """``"<algo>:<8 hex digits>"`` over ``data`` (str or bytes-like)."""
    if isinstance(data, str):
        data = data.encode("ascii")
    return f"{_CRC_ALGO}:{_crc_impl(data) & 0xFFFFFFFF:08x}"


def verify_digest(data, token: str) -> bool:
    """True when ``data`` matches ``token``. A token of an unknown
    algorithm verifies True (a writer built with the other CRC is not
    corruption); a malformed token verifies False."""
    algo, sep, hexval = (token or "").partition(":")
    if not sep or len(hexval) != 8:
        return False
    if algo != _CRC_ALGO:
        return True
    if isinstance(data, str):
        data = data.encode("ascii")
    try:
        want = int(hexval, 16)
    except ValueError:
        return False
    return (_crc_impl(data) & 0xFFFFFFFF) == want


# ---------------------------------------------------------------------------
# Layer 2: screening in the domain a contribution arrived in
# ---------------------------------------------------------------------------

# int8lat's all-zero sentinel exponent (compression/codecs.py _ZERO_EXP),
# spelled here so this module stays a leaf.
_ZERO_EXP = -32768
# |e| beyond this means a scale of 2^64: no healthy float32 gradient gets
# there (a shared leaf scale that large means the leaf already blew past
# anything an optimizer survives).
_EXP_BOUND = 64


def _is_tensor(leaf: Any) -> bool:
    return hasattr(leaf, "is_floating_point") and hasattr(leaf, "detach")


def _tensor_stats(leaves: Sequence[Any]) -> Dict[int, Tuple[bool, float]]:
    """Leaf index -> (all finite, float64 sum of squares) of every float
    tensor leaf of one contribution, computed on the leaves' device and
    read back with one host sync. Empty when no leaf is a float tensor."""
    idx = [j for j, leaf in enumerate(leaves)
           if _is_tensor(leaf) and leaf.is_floating_point()]
    if not idx:
        return {}
    import torch
    finite, sq = [], []
    for j in idx:
        flat = leaves[j].detach().reshape(-1)
        finite.append(torch.isfinite(flat).all())
        d = flat.double()
        sq.append(torch.dot(d, d))
    dev = sq[0].device
    got = torch.stack([torch.stack(finite).to(dev, torch.float64),
                       torch.stack([s.to(dev) for s in sq])]).tolist()
    return {j: (bool(f), float(s)) for j, f, s in zip(idx, got[0], got[1])}


def validate_payload(payload: Any,
                     expect_shape: Optional[Tuple[int, ...]] = None
                     ) -> Optional[str]:
    """Screen ONE compressed payload dict; -> None when clean, else a short
    reason string. Recognizes the homomorphic wire formats by their keys:
    int8lat ``{"v", "e"}``, topk/randk ``{"i", "v", "s"}``. Cheap on
    purpose: dtype, range and shape arithmetic only, no decode."""
    if not isinstance(payload, dict) or "v" not in payload:
        return "not a payload dict"
    v = payload["v"]
    if "e" in payload:                  # int8lat lattice payload
        try:
            e = int(payload["e"])
        except (TypeError, ValueError):
            return "int8lat exponent not an integer"
        if e != _ZERO_EXP and abs(e) > _EXP_BOUND:
            return f"int8lat exponent {e} out of bounds (|e| > {_EXP_BOUND})"
        v = np.asarray(v)
        if v.dtype != np.int8:
            return f"int8lat values dtype {v.dtype} != int8"
        if expect_shape is not None and tuple(v.shape) != tuple(expect_shape):
            return (f"int8lat shape {tuple(v.shape)} != expected "
                    f"{tuple(expect_shape)}")
        return None
    if "i" in payload:                  # topk/randk sparse payload
        if "s" not in payload:
            return "sparse payload missing shape"
        idx = np.asarray(payload["i"])
        vals = np.asarray(v)
        shape = tuple(int(d) for d in np.asarray(payload["s"]).ravel())
        if any(d < 0 for d in shape):
            return f"sparse shape {shape} has a negative dim"
        if not np.issubdtype(idx.dtype, np.integer):
            return f"sparse index dtype {idx.dtype} not integer"
        if idx.ndim != 1 or vals.ndim != 1 or len(idx) != len(vals):
            return (f"sparse index/value mismatch "
                    f"({idx.shape} vs {vals.shape})")
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if len(idx):
            if int(idx[0]) < 0 or int(idx[-1]) >= n:
                # The encoder emits sorted indices, so the endpoints bound
                # the range; a corrupted payload need not be sorted, hence
                # the full check below.
                return f"sparse index out of range [0, {n})"
            if ((idx < 0) | (idx >= n)).any():
                return f"sparse index out of range [0, {n})"
            if (np.diff(idx) <= 0).any():
                return "sparse indices not strictly increasing (duplicates)"
        if not np.isfinite(vals).all():
            return "sparse values not finite"
        if expect_shape is not None and shape != tuple(expect_shape):
            return f"sparse shape {shape} != expected {tuple(expect_shape)}"
        return None
    return "unrecognized payload keys"


def _float_verdict(finite: bool) -> Optional[str]:
    return None if finite else "non-finite gradient values"


def validate_float_leaf(leaf: Any) -> Optional[str]:
    """The uncompressed-path screen: a float gradient leaf must be finite
    everywhere (a NaN/Inf leaf averaged in poisons the whole update).
    Integer leaves pass; a tensor is checked on its device."""
    if _is_tensor(leaf):
        if not leaf.is_floating_point():
            return None
        return _float_verdict(_tensor_stats([leaf])[0][0])
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return None                     # int masks etc.: nothing to screen
    return _float_verdict(bool(np.isfinite(arr).all()))


def payload_norm(payload: Any) -> float:
    """Squared-L2 contribution of one payload or leaf WITHOUT decoding:
    int8lat -> (2^e)^2 * sum(v^2); sparse -> sum(v^2); float leaf ->
    sum(leaf^2) (a tensor's on its device, in float64). NaN propagates
    (the MAD gate treats non-finite as an automatic outlier)."""
    if isinstance(payload, dict) and "v" in payload:
        v = np.asarray(payload["v"], np.float64)
        sq = float(np.dot(v.ravel(), v.ravel()))
        if "e" in payload:
            e = int(payload["e"])
            if e == _ZERO_EXP:
                return 0.0
            return sq * float(2.0 ** (2 * min(max(e, -_EXP_BOUND),
                                              _EXP_BOUND)))
        return sq
    if _is_tensor(payload):
        return _tensor_stats([payload.double()])[0][1]
    arr = np.asarray(payload, np.float64)
    return float(np.dot(arr.ravel(), arr.ravel()))


def _contribution_norm(leaves: Sequence[Any],
                       stats: Dict[int, Tuple[bool, float]]) -> float:
    total = 0.0
    for j, leaf in enumerate(leaves):
        if isinstance(leaf, dict):
            if "v" in leaf:
                total += payload_norm(leaf)
        elif j in stats:
            total += stats[j][1]
        elif hasattr(leaf, "dtype") and hasattr(leaf, "shape") \
                and not _is_tensor(leaf):
            arr = np.asarray(leaf)
            if np.issubdtype(arr.dtype, np.floating):
                total += payload_norm(arr)
    return float(np.sqrt(total))


def contribution_norm(leaves: Sequence[Any]) -> float:
    """L2 norm of one contributor's whole gradient, in whatever domain the
    leaves arrived in (payload dicts, float arrays or tensors). Opaque
    leaves (pre-codec bytes, quantized tuples, ...) contribute 0: they
    cannot be screened cheaply in this domain."""
    return _contribution_norm(leaves, _tensor_stats(leaves))


def mad_outliers(norms: Dict[int, float], threshold: float = 6.0,
                 min_contributors: int = 4) -> List[int]:
    """Robust cross-contributor outlier gate: ids whose gradient norm sits
    more than ``threshold`` robust standard deviations (1.4826 * MAD) ABOVE
    the median; one-sided, because a small norm is a quiet replica, not a
    poisoned one. Non-finite norms are always outliers. With fewer than
    ``min_contributors`` finite norms the gate abstains (the median of 2 is
    meaningless), so tiny fleets rely on the validators and watchdogs."""
    bad = [cid for cid, n in norms.items() if not np.isfinite(n)]
    finite = {cid: n for cid, n in norms.items() if np.isfinite(n)}
    if len(finite) < int(min_contributors):
        return sorted(bad)
    vals = np.asarray(list(finite.values()), np.float64)
    med = float(np.median(vals))
    sigma = 1.4826 * float(np.median(np.abs(vals - med)))
    for cid, n in finite.items():
        # The 4x-median floor keeps the gate quiet when MAD degenerates to
        # ~0 (more than half the contributors bitwise-identical): a norm
        # must be both statistically extreme AND materially larger.
        if (n - med) > threshold * sigma and n > 4.0 * med + 1e-12:
            bad.append(cid)
    return sorted(bad)


# ---------------------------------------------------------------------------
# Layer 3: quarantine
# ---------------------------------------------------------------------------

class QuarantineManager:
    """Per-contributor strike ledger with probation-based readmission.

    - :meth:`strike` on every screened-out contribution; reaching
      ``strike_limit`` quarantines the contributor (event ``quarantine``).
    - a quarantined contributor's payloads keep being screened but never
      summed; ``readmit_clean`` CONSECUTIVE clean screens readmit it on
      probation (event ``readmit``) with ``strike_limit - 1`` strikes
      standing, so one more offense re-quarantines at once.
    - a clean contribution from a healthy contributor decays one strike,
      so transient corruption (a single torn write) never accumulates
      into an eviction.
    """

    def __init__(self, strike_limit: int = 3, readmit_clean: int = 3,
                 on_event: Optional[Callable[[str, int, int, str], None]]
                 = None):
        if strike_limit < 1:
            raise ValueError(f"strike_limit={strike_limit} (must be >= 1)")
        if readmit_clean < 1:
            raise ValueError(f"readmit_clean={readmit_clean} (must be >= 1)")
        self.strike_limit = int(strike_limit)
        self.readmit_clean = int(readmit_clean)
        self.on_event = on_event
        self._strikes: Dict[int, int] = {}
        self._quarantined: Dict[int, bool] = {}
        self._streak: Dict[int, int] = {}
        self.counters: Dict[str, int] = {
            "integrity_strikes": 0, "integrity_quarantines": 0,
            "integrity_readmissions": 0}

    def _emit(self, kind: str, cid: int, step: int, detail: str) -> None:
        if self.on_event is not None:
            self.on_event(kind, cid, step, detail)

    def is_quarantined(self, cid: int) -> bool:
        return bool(self._quarantined.get(cid, False))

    def quarantined_ids(self) -> List[int]:
        return sorted(c for c, q in self._quarantined.items() if q)

    def strike(self, cid: int, reason: str, step: int = 0) -> bool:
        """Record one offense; True when this strike QUARANTINED ``cid``."""
        cid = int(cid)
        self.counters["integrity_strikes"] += 1
        self._streak[cid] = 0
        self._strikes[cid] = self._strikes.get(cid, 0) + 1
        self._emit("strike", cid, step, reason)
        if not self._quarantined.get(cid, False) and \
                self._strikes[cid] >= self.strike_limit:
            self._quarantined[cid] = True
            self.counters["integrity_quarantines"] += 1
            self._emit("quarantine", cid, step, reason)
            return True
        return False

    def observe_clean(self, cid: int, step: int = 0) -> bool:
        """Record one clean screened contribution; True when it READMITTED
        a quarantined ``cid`` (probation: strikes stay at limit - 1)."""
        cid = int(cid)
        if self._quarantined.get(cid, False):
            self._streak[cid] = self._streak.get(cid, 0) + 1
            if self._streak[cid] >= self.readmit_clean:
                self._quarantined[cid] = False
                self._streak[cid] = 0
                self._strikes[cid] = self.strike_limit - 1
                self.counters["integrity_readmissions"] += 1
                self._emit("readmit", cid, step, "probation")
                return True
            return False
        if self._strikes.get(cid, 0) > 0:
            self._strikes[cid] -= 1
        return False

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["integrity_quarantined"] = len(self.quarantined_ids())
        return out


class GradIntegrity:
    """The aggregator-side bundle: screening, the MAD gate and the
    quarantine behind one :meth:`screen` call, which the pool runs right
    before its sum.

    One instance per contributor-id space (slice ids at the flat tier,
    group ids at a hierarchy's root): strikes must not leak between id
    spaces.
    """

    def __init__(self, mad_threshold: float = 6.0,
                 mad_min_contributors: int = 4, strike_limit: int = 3,
                 readmit_clean: int = 3,
                 on_event: Optional[Callable[[str, int, int, str], None]]
                 = None):
        if mad_threshold <= 0:
            raise ValueError(f"mad_threshold={mad_threshold} (must be > 0)")
        self.mad_threshold = float(mad_threshold)
        self.mad_min = int(mad_min_contributors)
        self.quarantine = QuarantineManager(
            strike_limit=strike_limit, readmit_clean=readmit_clean,
            on_event=on_event)
        self.counters: Dict[str, int] = {
            "integrity_screen_rejects": 0, "integrity_outlier_rejects": 0}

    def screen(self, contributions: Sequence[Tuple[int, Sequence[Any]]],
               step: int = 0,
               expect_shapes: Optional[Sequence[Tuple[int, ...]]] = None
               ) -> Tuple[List[int], Dict[int, str]]:
        """Screen one round of pooled contributions.

        ``contributions``: [(contributor_id, leaves)], leaves payload dicts
        on the homomorphic wire, float arrays or tensors on the plain path.
        -> (admitted ids, {rejected id: reason}). Quarantined contributors
        are rejected with reason ``"quarantined"`` (their payloads still
        screen, feeding the probation streak); validator and MAD failures
        strike."""
        reasons: Dict[int, str] = {}
        norms: Dict[int, float] = {}
        for cid, leaves in contributions:
            stats = _tensor_stats(leaves)
            reason = None
            for j, leaf in enumerate(leaves):
                if isinstance(leaf, dict):
                    shape = (tuple(expect_shapes[j])
                             if expect_shapes is not None else None)
                    reason = validate_payload(leaf, expect_shape=shape)
                elif _is_tensor(leaf):
                    reason = (_float_verdict(stats[j][0]) if j in stats
                              else None)
                elif hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
                    reason = validate_float_leaf(leaf)
                else:
                    continue    # opaque (pre-codec bytes, quantized
                    # tuples): layer 1 digests are that wire's screen
                if reason is not None:
                    reason = f"leaf {j}: {reason}"
                    break
            if reason is not None:
                reasons[cid] = reason
                self.counters["integrity_screen_rejects"] += 1
            else:
                norms[cid] = _contribution_norm(leaves, stats)
        for cid in mad_outliers(norms, self.mad_threshold, self.mad_min):
            reasons[cid] = f"outlier: norm {norms[cid]:.3e} vs median of " \
                           f"{len(norms)} contributors"
            self.counters["integrity_outlier_rejects"] += 1
        admitted: List[int] = []
        for cid, _ in contributions:
            if cid in reasons:
                self.quarantine.strike(cid, reasons[cid], step)
                continue
            self.quarantine.observe_clean(cid, step)
            if self.quarantine.is_quarantined(cid):
                reasons[cid] = "quarantined"
                continue
            admitted.append(cid)
        return admitted, reasons

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.counters)
        out.update(self.quarantine.snapshot())
        return out
