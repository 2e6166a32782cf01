"""The port's checkpoints against ``vince_tpu.utils.checkpoint``: the same
rolling and long-save directories after one sequence of saves, the same
prefix remap of top-level module names, None from an empty directory; and
a save → restore that is bit-identical and writes into the state's own
tensors."""

import os

import numpy as np
import pytest
import torch

from vince_tpu.utils.checkpoint import CheckpointManager as JaxManager
from vince_tpu.utils.checkpoint import _rename_tree
from vince_tpu_torch.solvers.vince_step import (
    SourceSpec, VinceConfig, build_vince_optimizer, init_vince_state, make_train_step_fn)
from vince_tpu_torch.utils.checkpoint import (
    CheckpointManager, _rename_modules, load_state_tree, state_tree)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

CFG = VinceConfig(sources=(SourceSpec("YT", batch_size=4, num_frames=2),), backbone="ResNet18",
                  embed_size=16, image_size=32, queue_size=8)
OPT = build_vince_optimizer(0.03)
# eleven saves, one of them a step saved before
STEPS = [1, 2, 3, 4, 5, 6, 7, 8, 8, 9, 10]


def _state(seed=0):
    return init_vince_state(seed, CFG, OPT, device="cpu")


def _tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _train(state, steps=1):
    """A step that moves weights, statistics, traces, the queue and the step."""
    step = make_train_step_fn(CFG, OPT)
    rng = np.random.RandomState(state.step)
    for _ in range(steps):
        batch = ({"data": torch.from_numpy(rng.randint(0, 255, (4, 36, 36, 3), np.uint8)),
                  "queue_data": torch.from_numpy(rng.randint(0, 255, (4, 36, 36, 3),
                                                             np.uint8))},)
        step(state, batch, 0)


def test_rolling_and_long_save_directories_match(tmp_path):
    state = _state()
    ours = CheckpointManager(tmp_path / "ours", tmp_path / "ours_long", max_to_keep=5,
                             long_save_frequency=3)
    ref = JaxManager(str(tmp_path / "ref"), str(tmp_path / "ref_long"), max_to_keep=5,
                     long_save_frequency=3)
    for s in STEPS:
        state.step = s
        ours.save(s, state)
        ref.save(s, {"step": np.int64(s)})
    ours.close()
    ref.close()
    listing = lambda d: sorted(int(n) for n in os.listdir(d) if n.isdigit())  # noqa: E731
    for a, b in (("ours", "ref"), ("ours_long", "ref_long")):
        assert listing(tmp_path / a) == listing(tmp_path / b)
    assert listing(tmp_path / "ours") == [6, 7, 8, 9, 10]
    assert listing(tmp_path / "ours_long") == [3, 6, 8]
    assert sorted(os.listdir(tmp_path / "ours")) == ["10", "6", "7", "8", "9"]  # no temporaries
    assert [t["step"] for t in ours.timings] == [1, 2, 3, 4, 5, 6, 7, 8, 8, 9, 10]
    assert all(t["write_s"] >= 0 and t["host_copy_s"] >= 0 for t in ours.timings)
    # the repeated step 8 went only to the long directory
    assert CheckpointManager(tmp_path / "ours").latest_step() == ref.latest_step() == 10


@pytest.mark.parametrize("saved,new", [("", ""), ("embedding", "proj"), ("back,emb", "b,e"),
                                       ("pool", "")])
def test_prefix_remap_matches(saved, new):
    state = _state()
    names = list(state.model.state_dict())
    tops = sorted({n.split(".")[0] for n in names})
    saved_p, new_p = saved.split(","), new.split(",")
    ref = _rename_tree({t: t for t in tops}, saved_p, new_p)
    got = _rename_modules({n: n for n in names}, saved_p, new_p)
    assert sorted({n.split(".")[0] for n in got}) == sorted(ref)
    # the rest of each name is kept, and each renamed name maps back to its module
    for new_name, old_name in got.items():
        old_top = old_name.split(".")[0]
        assert new_name.split(".")[0] == [k for k, v in ref.items() if v == old_top][0]
        assert new_name.split(".", 1)[1] == old_name.split(".", 1)[1]


def test_restore_with_a_remap_copies_the_names_that_match(tmp_path):
    a, b = _state(0), _state(1)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, a)
    mgr.close()
    b_embedding = {k: v.clone() for k, v in b.model.state_dict().items()
                   if k.startswith("embedding.")}
    CheckpointManager(tmp_path / "ck").restore(b, saved_variable_prefix=["embedding"],
                                               new_variable_prefix=["proj"])
    for k, v in b.model.state_dict().items():
        ref = b_embedding[k] if k.startswith("embedding.") else a.model.state_dict()[k]
        assert torch.equal(v, ref), k
    with pytest.raises(ValueError, match="missing"):
        load_state_tree(b, {**state_tree(a), "model": {}})


def test_empty_directory_restores_none(tmp_path):
    mgr = CheckpointManager(tmp_path / "none")
    assert mgr.latest_step() is None
    assert mgr.restore_raw() is None
    assert mgr.restore(_state()) is None
    assert JaxManager(str(tmp_path / "none_ref")).restore({}) is None


def test_save_then_restore_is_bit_identical_and_in_place(tmp_path):
    state = _state()
    _train(state, 2)
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in _tensors(state_tree(state)).items()}
    inserted = state.queue.inserted
    mgr = CheckpointManager(tmp_path / "ck", tmp_path / "long", long_save_frequency=1)
    mgr.save(state.step, state)
    ptrs = {k: v.data_ptr() for k, v in _tensors(state_tree(state)).items()
            if isinstance(v, torch.Tensor)}
    _train(state, 1)  # moves every tensor of the state on
    moved = _tensors(state_tree(state))
    assert not torch.equal(moved["queue/vectors"], saved["queue/vectors"])
    mgr.close()

    restored = CheckpointManager(tmp_path / "ck").restore(state)
    assert restored is state
    after = _tensors(state_tree(state))
    assert after.keys() == saved.keys()
    for k, v in saved.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(after[k], v) and after[k].dtype == v.dtype, k
            assert after[k].data_ptr() == ptrs[k], k
        else:
            assert after[k] == v, k
    assert state.step == 2 and state.queue.inserted == inserted == 8
    # the long save holds the same file
    long_raw = CheckpointManager(tmp_path / "long").restore_raw(2)
    for k, v in _tensors(long_raw).items():
        assert torch.equal(v, saved[k]) if isinstance(v, torch.Tensor) else v == saved[k]
