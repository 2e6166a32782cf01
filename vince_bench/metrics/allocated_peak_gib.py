"""allocated_peak_gib: the most that the program's tensors held on the card
at once over set-up and window (the caching allocator's peak of allocated
bytes), in GiB. ``peak_mem_gib`` counts what the allocator reserved from the
card, which also holds the blocks it keeps cached, such as the eager
warm-up's beside the captured step's private pool; where the allocator runs
into the card's size it gives its cached blocks back and retries, so that
number stops at the card. This one shows what the tensors need below it."""

LAYER = "allocator"
MOVES = "peak_mem_gib"


def read(rec):
    peak = rec.memory.get("allocated_peak")
    return peak / 2 ** 30 if peak else None
