#!/usr/bin/env python
"""Export a checkpoint of the port back to the reference's PyTorch format,
the inverse of ``convert_reference_checkpoint.py`` (counterpart of
``tools/export_reference_checkpoint.py``):

    python vince_tpu_torch/tools/export_reference_checkpoint.py \\
        --checkpoint-dir logs/vince/checkpoints_<desc> --output /path/to/vince_weights.pt

The query encoder's parameters and running statistics become a
``VinceModel`` state dict under the reference's names
(``feature_extractor.module.model.*``, ``embedding.{0,2}``,
``imagenet_decoders.*``; ``utils/jax_weights.py::to_reference_name``), with
a zero ``num_batches_tracked`` per BatchNorm. ``--encoder key`` exports the
momentum (key) encoder, whose modules are the tracked ones (no decoders).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--encoder", default="query", choices=["query", "key"],
                        help="query = the trained encoder; key = the momentum encoder")
    args = parser.parse_args(argv)

    import torch

    from vince_tpu_torch.models.vince_model import split_vince_params
    from vince_tpu_torch.utils.checkpoint import CheckpointManager
    from vince_tpu_torch.utils.torch_convert import export_vince_state_dict

    mgr = CheckpointManager(args.checkpoint_dir, None)
    step = args.step if args.step is not None else mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
    raw = mgr.restore_raw(step)
    mgr.close()
    tensors = (split_vince_params(raw["key_model"])[0] if args.encoder == "key"
               else raw["model"])
    sd = export_vince_state_dict(tensors)
    torch.save(sd, args.output)
    print(f"exported step {step} ({args.encoder} encoder): {len(sd)} tensors -> {args.output}")
    return sd


if __name__ == "__main__":
    main()
