"""What the program's own spans and counters recorded in a ``--trace 1``
run (``multimodal_concept_learning_tpu_torch/utils/profiling.py``): the
rows of the session with the most steps.  That is window A's, which traces
the card only, has the most steps and stretches the host least.  A program
without the recorder, or a run that recorded nothing, gives no rows, and
the readers below give None."""

from typing import List, Optional


def rows() -> List[dict]:
    from multimodal_concept_learning_tpu_torch.utils import profiling

    rec = getattr(profiling, "recorder", None)
    sessions = rec.sessions() if rec is not None else {}
    if not sessions:
        return []
    return rec.rows(max(sessions, key=lambda s: (sessions[s], -s)))


def span_ms(name: str) -> Optional[float]:
    """The mean host time a step of the program's spans called ``name``."""
    found = rows()
    return sum(r["host_ms"].get(name, 0.0) for r in found) / len(found) if found else None


def counter(name: str) -> Optional[float]:
    """The mean a step of the program's counter ``name``."""
    found = rows()
    return sum(r["counters"].get(name, 0) for r in found) / len(found) if found else None
