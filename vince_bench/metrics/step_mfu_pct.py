"""step_mfu_pct: the model's operations of every step of the window before
the traced stretch, over that time, as a share of the card's bf16 peak
(``vince_bench/counts.py``: key forward, query forward, query backward at
twice the forward, and InfoNCE's products; nothing recomputed)."""

from vince_bench import counts

LAYER = "step"
MOVES = "frames_per_s"


def read(rec):
    if rec.untraced_steps == 0 or rec.untraced_s <= 0:
        return None
    return counts.mfu_pct(counts.step_flops(rec.config) * rec.untraced_steps, rec.untraced_s)
