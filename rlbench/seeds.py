"""Seeds derived from the run's ``--seed``: every draw of a run has its
own stream, named by tags, so the same seed gives the same inputs and
weights whatever else the run does."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of run seed ``seed``."""
    text = "/".join(str(t) for t in (int(seed),) + tags)
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
