"""GOT-10k SiamFC pairs (counterpart of ``vince_tpu/data/got10k_dataset.py``),
registry name ``GOT10kDataset``: the GOT-10k sequences under ``--data-path``
or, without it, 8 synthetic sequences in memory (the texture family with
``--synthetic-texture``), through ``PairDataset`` and the SiamFC transforms
of ``TRACKER_CFG``: exemplar crops of 120, search crops of 247 and 17×17
labels of positive width 5.

The draws come from one ``RandomState(seed)``: ``rng`` where it is given,
else the run's ``--seed`` (plus 1 for the val split). The split's
permutation and every item share it, so the items follow from the seed only
when one thread draws them in order; with several loader threads, which
item gets which draws depends on their scheduling (as with JAX's global
generator).
"""

from typing import Optional

import numpy as np

from vince_tpu_torch.data.pair_dataset import PairDataset
from vince_tpu_torch.tracking.sequences import (
    GOT10kSequences,
    SyntheticSequences,
    TextureSequences,
)
from vince_tpu_torch.tracking.siamfc_transforms import SiamFCTransforms

TRACKER_CFG = {
    # the reference tracking solver's settings, used everywhere
    "out_scale": 0.001,
    "exemplar_sz": 120,
    "instance_sz": 255,
    "context": 0.5,
    "scale_num": 3,
    "scale_step": 1.0375,
    "scale_lr": 0.59,
    "scale_penalty": 0.9745,
    "window_influence": 0.176,
    "response_sz": 17,
    "response_up": 16,
    "positive_label_width": 5,
    "total_stride": 8,
    "epoch_num": 50,
    "batch_size": 8,
    "initial_lr": 1e-2,
    "ultimate_lr": 1e-5,
    "weight_decay": 5e-4,
    "momentum": 0.9,
    "r_pos": 16,
    "r_neg": 0,
}


def make_pair_transform(cfg=None, rng: Optional[np.random.RandomState] = None):
    cfg = cfg or TRACKER_CFG
    return SiamFCTransforms(exemplar_sz=cfg["exemplar_sz"], instance_sz=cfg["instance_sz"],
                            context=cfg["context"], label_size=cfg["response_sz"],
                            positive_label_width=cfg["positive_label_width"], rng=rng)


class GOT10kDataset(PairDataset):
    def __init__(self, args, data_subset: str = "train", pairs_per_seq: int = 25,
                 rng: Optional[np.random.RandomState] = None):
        if getattr(args, "data_path", None):
            seqs = GOT10kSequences(args.data_path, "train" if data_subset == "train" else "val")
        elif getattr(args, "synthetic_texture", False):
            seqs = TextureSequences(num_seqs=8)
        else:
            seqs = SyntheticSequences(num_seqs=8)
        if rng is None:
            rng = np.random.RandomState(getattr(args, "seed", 0) + (data_subset != "train"))
        super().__init__(args, seqs, data_subset, pair_transform=make_pair_transform(rng=rng),
                         pairs_per_seq=pairs_per_seq, rng=rng)
