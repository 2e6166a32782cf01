"""k2_roofline: K2 (affine_relu_dot_moments: ``ardm_main_kernel``,
``ardm_moments_kernel``, ``ardm_reduce_kernel``) over a step's sites, the sum
of their least times by ``vince_bench/counts.py`` over their device time in
the traced stretch. The sites are those of the key and the query forwards
(``counts.k2_sites``); a stretch whose launches are not that count a step is
not read. The weight's cast to bf16 before each launch is a PyTorch copy
kernel and is not counted in the time."""

from vince_bench import counts

LAYER = "kernels"
MOVES = "frames_per_s"
FORWARDS = 2  # the key encoder's and the query encoder's


def read(rec):
    t = rec.trace
    c = rec.config
    sites = counts.k2_sites(c)
    if t is None or t.steps == 0 or not sites:
        return None
    if len(t.matching(r"ardm_main_kernel")) != FORWARDS * len(sites) * t.steps:
        return None
    seconds = sum(e - s for _, s, e in t.matching(r"ardm_\w+_kernel"))
    bound = FORWARDS * t.steps * sum(counts.k2_bound_s(*site) for site in sites)
    return 100.0 * bound / seconds if seconds > 0 else None
