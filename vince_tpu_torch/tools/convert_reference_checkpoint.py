#!/usr/bin/env python
"""Convert a reference PyTorch VINCE checkpoint into a checkpoint directory
of the port (``utils/checkpoint.py``'s format), ready for ``--restore`` of
the pretraining solver or for an end task's ``--checkpoint-dir``
(counterpart of ``tools/convert_reference_checkpoint.py``):

    python vince_tpu_torch/tools/convert_reference_checkpoint.py \\
        --torch-checkpoint /path/to/vince_weights.pt \\
        --backbone ResNet18 --embed-size 64 \\
        --output-dir logs/vince/checkpoints_r18-b-256-q-65536

Both encoders take the converted weights and running statistics (the key
encoder is a copy of the query encoder); the queue and the optimizer's
traces are fresh, from seed 0: the reference checkpoints neither. The
checkpoint has the ImageNet decoders when the file has them. The flags of
the restoring run must give the same backbone, embedding and queue sizes.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--torch-checkpoint", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--backbone", default="ResNet18")
    parser.add_argument("--embed-size", type=int, default=64)
    parser.add_argument("--queue-size", type=int, default=65536)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--optimizer", default="sgd", choices=("sgd", "lars"),
                        help="the --optimizer of the restoring run (the momentum traces "
                             "are zero either way)")
    args = parser.parse_args(argv)

    from vince_tpu_torch.solvers.vince_step import (
        SourceSpec, VinceConfig, build_vince_optimizer, init_vince_state)
    from vince_tpu_torch.utils.checkpoint import CheckpointManager
    from vince_tpu_torch.utils.torch_convert import (
        convert_vince_state_dict, init_from_reference, load_torch_checkpoint)

    tensors = convert_vince_state_dict(load_torch_checkpoint(args.torch_checkpoint))
    has_decoders = any(k.startswith("imagenet_decoder_0.") for k in tensors)
    cfg = VinceConfig(
        sources=(SourceSpec("IN", batch_size=2, num_frames=1, use_imagenet_ce=True)
                 if has_decoders else SourceSpec("YT", batch_size=2, num_frames=1),),
        backbone=args.backbone, embed_size=args.embed_size, image_size=args.image_size,
        queue_size=args.queue_size)
    state = init_vince_state(0, cfg, build_vince_optimizer(0.03, kind=args.optimizer),
                             device="cpu")
    loaded = init_from_reference(state, tensors)
    state.step = args.step
    mgr = CheckpointManager(args.output_dir, None, max_to_keep=5)
    mgr.save(args.step, state)
    mgr.close()
    print(f"converted modules: {loaded}")
    print(f"wrote checkpoint step {args.step} to {args.output_dir}")
    return loaded


if __name__ == "__main__":
    main()
