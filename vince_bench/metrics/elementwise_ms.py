"""elementwise_ms: device milliseconds a step in PyTorch's elementwise and
reduction kernels, from the traced stretch's kernels by name: mostly the
encoder's BatchNorm passes in float32, its casts, ReLUs and residual adds,
with the augmentation's and the loss's elementwise work beside them (the
optimizer's and the EMA's foreach kernels are not matched)."""

LAYER = "encoder"
MOVES = "frames_per_s"
# PyTorch's generic TensorIterator kernels: elementwise (vectorized, unrolled
# or strided) and reductions
PATTERN = r"elementwise_kernel|reduce_kernel"


def read(rec):
    t = rec.trace
    if t is None or t.steps == 0:
        return None
    hits = t.matching(PATTERN)
    if not hits:
        return None
    return 1e3 * sum(e - s for _, s, e in hits) / t.steps
