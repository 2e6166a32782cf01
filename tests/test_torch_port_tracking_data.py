"""The tracking data of the port against the JAX package's under the same
seeds: ``np.random.seed(s)`` on the JAX side, ``RandomState(s)`` given to the
port. The JAX datasets read their frames from files; the test writes them as
PNG, which is lossless (under ``.jpg`` names where the GOT-10k reader globs
for them: ``cv2.imread`` decodes by content), and the port gets the same
frames in memory or reads the same files.

Tolerances: pair indices, boxes and labels exactly; crops within 1 of 255 on
at most 1e-3 of the pixels (the crop's tolerance in
``test_torch_port_tracking_ops.py``). The synthetic sequences' annotations
equal JAX's exactly, and their frames are the JAX generator's frames before
its JPEG write."""


import cv2
import numpy as np
import pytest

from vince_tpu.data import got10k_dataset as jgot
from vince_tpu.data import pair_dataset as jpair
from vince_tpu.tracking import sequences as jseq
from vince_tpu.tracking import siamfc_transforms as jtr
from vince_tpu_torch.data import get_dataset
from vince_tpu_torch.data import got10k_dataset as tgot
from vince_tpu_torch.data import pair_dataset as tpair
from vince_tpu_torch.data.loader import collate_video_batch
from vince_tpu_torch.tracking import sequences as tseq
from vince_tpu_torch.tracking import siamfc_transforms as ttr
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

CROP_MAX, CROP_FRACTION = 1, 1e-3


class Args:
    input_width = 224
    data_path = None
    synthetic_texture = False
    seed = 0


def _crop_close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= CROP_MAX and (d > 0).mean() <= CROP_FRACTION, (d.max(), (d > 0).mean())


def _item_close(got, ref):
    assert sorted(got) == sorted(ref) == ["exemplar", "ind", "labels", "search"]
    assert got["ind"] == ref["ind"]
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert got["labels"].dtype == np.float32 and got["labels"].shape == (17, 17)
    _crop_close(got["exemplar"], ref["exemplar"])
    _crop_close(got["search"], ref["search"])
    assert got["exemplar"].shape == (120, 120, 3) and got["search"].shape == (247, 247, 3)


def _write_png(path, frame):
    ok, buf = cv2.imencode(".png", frame[:, :, ::-1])
    assert ok
    buf.tofile(str(path))


def _sequences(seed=0, num_seqs=3, num_frames=6):
    """In-memory sequences with varied boxes, sizes and aspects (some frames
    fail the c1-c7 filters)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(num_seqs):
        h, w = rng.randint(150, 260, 2)
        frames = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(num_frames)]
        anno = np.c_[rng.uniform(0, w / 2, num_frames), rng.uniform(0, h / 2, num_frames),
                     rng.uniform(15, w / 2, num_frames), rng.uniform(15, h / 2, num_frames)]
        out.append((frames, anno))
    return out


class _Files:
    """JAX's view of ``_sequences``: PNG files."""

    def __init__(self, seqs, root):
        self.items = []
        for si, (frames, anno) in enumerate(seqs):
            paths = []
            for fi, f in enumerate(frames):
                p = root / f"{si}_{fi}.png"
                _write_png(p, f)
                paths.append(str(p))
            self.items.append((paths, anno))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _Memory(_Files):
    def __init__(self, seqs):
        self.items = seqs


@pytest.mark.parametrize("seed", [0, 1])
def test_siamfc_transforms_match(seed):
    (frames, anno), = _sequences(seed, num_seqs=1, num_frames=2)
    kw = dict(exemplar_sz=120, instance_sz=255, context=0.5, label_size=17,
              positive_label_width=5)
    np.random.seed(seed)
    z_ref, (x_ref, l_ref) = jtr.SiamFCTransforms(**kw)((frames[0], frames[1], anno[0], anno[1]))
    z, (x, lab) = ttr.SiamFCTransforms(**kw, rng=np.random.RandomState(seed))(
        (frames[0], frames[1], anno[0], anno[1]))
    _crop_close(z, z_ref)
    _crop_close(x, x_ref)
    np.testing.assert_array_equal(lab, l_ref)
    assert 0 < lab.sum() <= 41


@pytest.mark.parametrize("subset", ["train", "val"])
def test_pair_dataset_items_match(tmp_path, subset):
    seqs = _sequences(2)
    np.random.seed(5)
    ref_ds = jpair.PairDataset(Args(), _Files(seqs, tmp_path), subset,
                               pair_transform=jgot.make_pair_transform(), pairs_per_seq=4)
    rng = np.random.RandomState(5)
    got_ds = tpair.PairDataset(Args(), _Memory(seqs), subset,
                               pair_transform=tgot.make_pair_transform(rng=rng),
                               pairs_per_seq=4, rng=rng)
    np.testing.assert_array_equal(got_ds.indices, ref_ds.indices)
    assert len(got_ds) == len(ref_ds) == 12
    for i in range(len(ref_ds)):  # one stream on each side: the draws stay in step
        _item_close(got_ds[i], ref_ds[i])
    assert got_ds.seq_sizes == {k: tuple(v) for k, v in ref_ds.seq_sizes.items()}


def _got10k_layout(root, seqs):
    """``<root>/train/<seq>/{00000001.jpg, ..., groundtruth.txt}``, the frames
    PNG-coded."""
    for si, (frames, anno) in enumerate(seqs):
        d = root / "train" / f"GOT-10k_{si:06d}"
        d.mkdir(parents=True)
        for fi, f in enumerate(frames):
            _write_png(d / f"{fi + 1:08d}.jpg", f)
        np.savetxt(d / "groundtruth.txt", anno, delimiter=",", fmt="%.4f")


def test_got10k_dataset_from_files_matches(tmp_path):
    _got10k_layout(tmp_path, _sequences(3))
    args = Args()
    args.data_path = str(tmp_path)
    np.random.seed(9)
    ref_ds = jgot.GOT10kDataset(args, "train", pairs_per_seq=3)
    got_ds = get_dataset("GOT10kDataset")(args, "train", pairs_per_seq=3,
                                          rng=np.random.RandomState(9))
    assert isinstance(got_ds.seqs, tseq.GOT10kSequences)
    assert got_ds.seqs.seq_names == ref_ds.seqs.seq_names
    for i in range(len(ref_ds)):
        _item_close(got_ds[i], ref_ds[i])


@pytest.mark.parametrize("family", ["SyntheticSequences", "TextureSequences"])
def test_synthetic_sequences_match_the_jax_generator(family):
    """The annotations equal JAX's; the frames equal the JAX generator's drawn
    again here before its JPEG write (``cv2.rectangle`` for the square)."""
    ref = getattr(jseq, family)(num_seqs=2, num_frames=5, seed=3)
    got = getattr(tseq, family)(num_seqs=2, num_frames=5, seed=3)
    assert got.seq_names == ref.seq_names
    for i in range(2):
        frames, anno = got[i]
        np.testing.assert_array_equal(anno, ref[i][1])
        assert len(frames) == len(ref[i][0]) == 5
        assert all(f.dtype == np.uint8 and f.shape == (240, 240, 3) for f in frames)
    if family == "SyntheticSequences":
        rng = np.random.RandomState(3)
        for i in range(2):
            bg = rng.randint(0, 100, (240, 240, 3), np.uint8)
            color = tuple(int(c) for c in rng.randint(180, 256, 3))
            rng.randint(20, 240 - 48 - 20, 2), rng.uniform(-3, 3, 2)
            for frame, box in zip(*got[i]):
                want = bg.copy()
                x, y = int(round(box[0] - 1)), int(round(box[1] - 1))
                cv2.rectangle(want, (x, y), (x + 48, y + 48), color, -1)
                np.testing.assert_array_equal(frame, want)
    else:  # the frames JAX wrote as JPEGs: close, not equal
        frame = cv2.imread(ref[0][0][0])[:, :, ::-1]
        assert np.abs(frame.astype(int) - got[0][0][0].astype(int)).mean() < 8


def test_got10k_synthetic_fallback_and_collate():
    """Without ``--data-path``: 8 sequences in memory, 25 pairs each, the
    annotations JAX's; a batch of items collates to the step's arrays."""
    ds = tgot.GOT10kDataset(Args(), "val")
    ref = jseq.SyntheticSequences(num_seqs=8)
    assert len(ds) == 200 and ds.data_subset == "val"
    for i in range(8):
        np.testing.assert_array_equal(ds.seqs[i][1], ref[i][1])
    batch = collate_video_batch([ds[i] for i in range(3)])
    assert batch["exemplar"].shape == (3, 120, 120, 3)
    assert batch["search"].shape == (3, 247, 247, 3)
    assert batch["labels"].shape == (3, 17, 17) and batch["ind"].shape == (3,)
    # the train split draws from RandomState(seed), the val split from seed + 1
    np.testing.assert_array_equal(ds.indices, np.random.RandomState(1).permutation(8))
    np.testing.assert_array_equal(tgot.GOT10kDataset(Args(), "train").indices,
                                  np.random.RandomState(0).permutation(8))
