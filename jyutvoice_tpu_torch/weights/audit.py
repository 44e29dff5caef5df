"""Conversion key-coverage audit: prove every source checkpoint key is used.

A copy of the JAX package's `weights/audit.py`. The converters in
torch_convert.py index source keys by name, so a *missing*
key fails loudly (KeyError) — but an *unconsumed* source key (a renamed
layer, an extra parametrization, a checkpoint from a different revision of
the reference) would be silently dropped and the converted pytree silently
wrong. The reference loads 1039 pretrained tensors
(reference README.md:231-234; split logic
scripts/download_pretrain_weights.py:168-215); this module is the gate that
makes converting them auditable:

  * `RecordingStateDict` wraps a source state_dict and records every key
    actually read by a converter;
  * `audit_convert(convert_fn, sd, ...)` runs a converter under it and, in
    strict mode, raises `ConversionAuditError` listing every ignored key.

tests/test_torch_port_prompt.py holds this copy to it: an extra key and a
renamed key fail loudly instead of converting to silently-wrong weights.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Callable, Iterable, Iterator, List, Mapping, Tuple

import numpy as np


class RecordingStateDict(Mapping):
    """Mapping wrapper that records which keys a converter reads.

    Membership checks (`"k" in sd`) do NOT count as consumption — converters
    probe for optional keys (bias, weight-norm styles) they then may or may
    not read.
    """

    def __init__(self, sd: Mapping[str, np.ndarray]):
        self._sd = dict(sd)
        self.consumed: set = set()

    def __getitem__(self, key: str) -> np.ndarray:
        val = self._sd[key]  # raise KeyError before recording
        self.consumed.add(key)
        return val

    def __contains__(self, key) -> bool:
        return key in self._sd

    def __iter__(self) -> Iterator[str]:
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)

    @property
    def ignored(self) -> List[str]:
        return sorted(set(self._sd) - self.consumed)


@dataclasses.dataclass
class AuditReport:
    total: int
    consumed: List[str]
    ignored: List[str]  # after allowlist filtering
    allowed: List[str]  # ignored but matching an allow pattern

    @property
    def ok(self) -> bool:
        return not self.ignored


class ConversionAuditError(ValueError):
    pass


# Source keys that are correct to leave unconsumed. Keep this list SHORT and
# justified — every entry is a key the reference itself never loads into
# compute (torch bookkeeping, not weights).
DEFAULT_ALLOW_IGNORED: Tuple[str, ...] = (
    "*.num_batches_tracked",  # BN step counter, not a weight
)


def _filter_allowed(
    ignored: Iterable[str], allow: Iterable[str]
) -> Tuple[List[str], List[str]]:
    bad, allowed = [], []
    for k in ignored:
        (allowed if any(fnmatch.fnmatch(k, pat) for pat in allow) else bad).append(k)
    return bad, allowed


def audit_convert(
    convert_fn: Callable,
    sd: Mapping[str, np.ndarray],
    *args,
    strict: bool = True,
    allow_ignored: Iterable[str] = DEFAULT_ALLOW_IGNORED,
    **kwargs,
):
    """Run `convert_fn(sd, *args, **kwargs)` with full key-coverage tracking.

    Returns (params, AuditReport). In strict mode raises
    ConversionAuditError if any source key outside `allow_ignored` was never
    read — the loud, actionable failure for renamed/extra checkpoint keys.
    """
    rec = RecordingStateDict(sd)
    params = convert_fn(rec, *args, **kwargs)
    bad, allowed = _filter_allowed(rec.ignored, allow_ignored)
    report = AuditReport(
        total=len(rec),
        consumed=sorted(rec.consumed),
        ignored=bad,
        allowed=allowed,
    )
    if strict and bad:
        preview = "\n  ".join(bad[:25])
        more = f"\n  ... and {len(bad) - 25} more" if len(bad) > 25 else ""
        raise ConversionAuditError(
            f"{convert_fn.__name__}: {len(bad)} of {report.total} source keys "
            f"were never consumed — the converted pytree would silently drop "
            f"them. Unconsumed keys:\n  {preview}{more}\n"
            "If a key is genuinely not a weight, add it to allow_ignored "
            "with a justification; otherwise the converter's name map is out "
            "of date for this checkpoint."
        )
    return params, report
