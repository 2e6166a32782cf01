#!/usr/bin/env python
"""Frame-retrieval probe of a pretraining checkpoint on the synthetic video
families (counterpart of ``tools/eval_retrieval.py``): embed F jittered
frames of each of N videos of the val split (identities the training run
never saw) through the restored solver's ``embed_fn``, then score
leave-one-out nearest-neighbour retrieval by cosine: does each frame's
nearest other frame come from the same video? Chance is (F−1)/(N·F−1); a run
with ``--no-restore`` gives the random-init baseline.

    python vince_tpu_torch/tools/eval_retrieval.py --title cli --description resnet50 \\
        --base-logdir LOGS --solver VinceSolver --dataset SyntheticTextureVideoDataset \\
        --backbone ResNet50 --vince-embedding-size 128 --vince-queue-size 65536 \\
        --input-width 224 --input-height 224 --num-frames 4 --use-videos \\
        --inter-batch-comparison --batch-size 128 --compute-dtype bfloat16 \\
        --retrieval-videos 64 --retrieval-frames 6 [--platform cpu]

The flags are the training run's (the checkpoint directory follows from
them, or from ``--checkpoint-dir``). Prints and returns a dict with
``retrieval_at_1``, ``chance`` and ``restored_step`` (the optimizer's step;
0 for random weights) among its keys.
"""

import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def retrieval_at_1(embeddings: np.ndarray, frames: int) -> float:
    """The share of the rows whose nearest other row by cosine belongs to
    the same video (consecutive groups of ``frames`` rows)."""
    flat = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    sims = flat @ flat.T
    np.fill_diagonal(sims, -np.inf)
    nearest = np.argmax(sims, axis=1)
    return float(((nearest // frames) == (np.arange(len(flat)) // frames)).mean())


def main(argv=None):
    from vince_tpu_torch.arg_parser import build_parser, finalize_args

    parser = build_parser()
    parser.add_argument("--retrieval-videos", type=int, default=64)
    parser.add_argument("--retrieval-frames", type=int, default=6)
    parser.add_argument("--retrieval-subset", default="val")
    args = finalize_args(parser.parse_args(argv))
    args.disable_dataloader = True  # no train loaders, no queue prefill

    import torch

    from vince_tpu_torch.data import get_dataset
    from vince_tpu_torch.solvers.vince_solver import VinceSolver

    n, f = args.retrieval_videos, args.retrieval_frames
    size, bs = args.input_width, args.batch_size
    solver = VinceSolver(args)
    try:
        ds_args = types.SimpleNamespace(num_frames=f, input_width=size, input_height=size,
                                        repeatable=True)
        ds = get_dataset(args.dataset or "SyntheticTextureVideoDataset")(
            ds_args, args.retrieval_subset, num_videos=n, num_images_to_return=f)

        def center_crop(img):
            y, x = (img.shape[0] - size) // 2, (img.shape[1] - size) // 2
            return img[y:y + size, x:x + size]

        # all N·F frames through embed_fn in batches of the run's size, the
        # last one padded with copies of its last frame
        frames = np.stack([np.stack([center_crop(fr) for fr in ds[i]["data"]])
                           for i in range(n)]).reshape(n * f, size, size, 3)
        feats = []
        for i in range(0, n * f, bs):
            chunk = frames[i:i + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            emb, _ = solver.embed_fn(solver.state, torch.from_numpy(chunk).to(solver.device))
            feats.append(emb.float().cpu().numpy()[: bs - pad])
        acc = retrieval_at_1(np.concatenate(feats), f)
        step = int(solver.state.step)
    finally:
        solver.end()
    chance = (f - 1) / (n * f - 1)
    print(f"{args.dataset} {args.retrieval_subset}: retrieval@1 = {acc:.4f} "
          f"(chance {chance:.4f}, {n} unseen videos x {f} frames, "
          f"{'step ' + str(step) if step else 'random-init'})")
    result = {
        "retrieval_at_1": round(acc, 4), "chance": round(chance, 4),
        "num_videos": n, "frames": f, "dataset": args.dataset,
        "subset": args.retrieval_subset, "restored_step": step,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
