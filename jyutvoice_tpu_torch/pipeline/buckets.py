"""Length buckets: padded text, mel and prompt lengths.

A copy of the JAX package's bucket tables, so both packages pad a request to
the same shapes; masks carry the true lengths.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# interactive sentences live in the first 8 buckets; the long tail lets a
# long text encode in one pass
TEXT_BUCKETS: Tuple[int, ...] = (32, 64, 96, 128, 192, 256, 384, 512,
                                 1024, 2048, 4096, 8192)
# text past this is long-form: the serving engine sends such a request
# through synthesize_long on its own instead of batching it
# (pipeline/server.py)
INTERACTIVE_TEXT_CAP = 512
# mel frames: 50/s -> up to 300 s (the reference's fixed noise buffer cap)
MEL_BUCKETS: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048,
                                3072, 4096, 6144, 8192, 12288, 15000)
PROMPT_BUCKETS: Tuple[int, ...] = (0, 64, 128, 256, 512)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")


def pick_prompt_bucket(p_len: int, t_mel: int) -> int:
    """Prompt bucket for a prompt of p_len frames at mel bucket t_mel.

    The same table and rule as the JAX package: from the 2048-frame mel
    bucket up, a prompt bucket that leaves prompt + mel off a multiple of 512
    is promoted to 512 (the JAX package aligns long totals for its own
    attention block; the rule is kept so both packages pick the same
    shapes)."""
    if p_len <= 0:
        return 0
    t = pick_bucket(p_len, PROMPT_BUCKETS[1:])
    if t_mel >= 2048 and t_mel % 512 == 0 and (t_mel + t) % 512:
        t = PROMPT_BUCKETS[-1]
    return t
