"""The training CLI's flags (counterpart of ``vince_tpu/arg_parser.py``): the
same names, defaults, cross-flag checks and derived paths.

Where the port differs:

- ``--platform`` takes ``cpu`` or ``cuda`` (default ``cuda``; without a CUDA
  device the solver raises rather than fall back);
- ``--dw-kind pallas`` selects the port's depthwise kernel (``dw_kind="kernel"``)
  and ``--fold-kernel`` its fused affine→ReLU→1×1 dot kernel;
- ``--distributed`` starts one process per GPU over ``torch.distributed``
  (``nccl``; ``gloo`` with ``--platform cpu``), from the three explicit flags
  or from ``torchrun``'s environment;
- ``--native-decode`` decodes the JPEGs on the run's device: nvJPEG and a
  resize kernel on the GPU (``vince_tpu_torch/native``); with
  ``--loader-processes`` the solver refuses it, naming the ``ROADMAP.md``
  item.

The end-task solvers (``EndTaskImagenetSolver``, ``EndTaskSunSceneSolver``,
``EndTaskKinetics400Solver``, ``EndTaskTrackingSolver``) take the same flags,
through this package's ``solver_runner`` (``--distributed`` included) and
``run_end_task_eval`` (one process).
"""

import argparse
import multiprocessing
import os

from vince_tpu_torch import constants
from vince_tpu_torch.data import __all__ as dataset_names
from vince_tpu_torch.models.backbones import __all__ as ported_backbones
from vince_tpu_torch.utils.transforms import __all__ as transform_names

SOLVER_NAMES = [
    "VinceSolver",
    "EndTaskImagenetSolver",
    "EndTaskSunSceneSolver",
    "EndTaskTrackingSolver",
    "EndTaskKinetics400Solver",
]
backbone_names = list(ported_backbones)


def _registry_type(names, kind):
    def check(value):
        if value not in names:
            raise argparse.ArgumentTypeError(
                f"Invalid {kind} {value}; choices: {names}"
            )
        return value

    return check


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Video Noise Contrastive Estimation training args (PyTorch + CUDA)"
    )
    # basic
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--title", type=str, required=True)
    parser.add_argument("--description", type=str, required=True)
    parser.add_argument(
        "--num-frames", type=int, default=1,
        help="Frames per video (pretraining) or per clip (Kinetics: a batch of "
        "--batch-size frames holds batch_size // num_frames clips).",
    )
    parser.add_argument("--test-first", action="store_true")
    parser.add_argument("--saved-variable-prefix", default="", type=str)
    parser.add_argument("--new-variable-prefix", default="", type=str)

    # paths
    parser.add_argument("--base-logdir", metavar="DIR", default="logs", type=str)
    parser.add_argument("--tensorboard-dir", metavar="DIR", default="tensorboard")
    parser.add_argument(
        "--checkpoint-dir", metavar="DIR",
        help="Pretraining checkpoints (default <base-logdir>/<title>/checkpoints_"
        "<description>); an end task reads its encoder from the latest one.",
    )
    parser.add_argument("--long-save-checkpoint-dir", metavar="DIR")

    # dataset
    parser.add_argument("--data-path", metavar="DIR")
    parser.add_argument("--dataset", type=_registry_type(dataset_names, "dataset"))
    parser.add_argument(
        "--transform",
        default="StandardVideoTransform",
        type=_registry_type(transform_names, "transform"),
    )

    # architecture
    parser.add_argument(
        "--solver", type=_registry_type(SOLVER_NAMES, "solver"),
        help="VinceSolver (pretraining) or an end task.",
    )
    parser.add_argument(
        "--backbone", metavar="ARCH", type=_registry_type(backbone_names, "backbone"),
        default="ResNet18",
    )
    parser.add_argument(
        "--end-task-classifier-num-classes", default=0, type=int,
        help="Classes of an end task's decoder (0 = 1000).",
    )
    parser.add_argument("--use-attention", action="store_true")
    parser.add_argument("--jigsaw", action="store_true")
    # which encoder(s) take the jigsaw head each step: "alternate" draws a
    # side per step, 50/50 (the reference); "both" jigsaws query and key
    parser.add_argument("--jigsaw-sides", default="alternate",
                        choices=("alternate", "both"))
    # the tracking end task's synthetic sequences from the texture family
    parser.add_argument("--synthetic-texture", action="store_true")
    # weight of PIRL's alignment of the jigsaw head with the plain projection
    # (0 is the reference)
    parser.add_argument("--jigsaw-align-weight", default=0.0, type=float)
    # the first N steps jigsaw both sides, then the alternation
    parser.add_argument("--jigsaw-warmup-steps", default=0, type=int)
    # in those N steps, every other step is a plain one (trains the plain
    # projection beside the jigsaw head)
    parser.add_argument("--jigsaw-warmup-mix", action="store_true")
    parser.add_argument(
        "--freeze-feature-extractor", action="store_true",
        help="End tasks: the encoder runs in eval mode and takes no update; "
        "without it the encoder is fine-tuned (train-mode BN, weight decay 1e-4).",
    )

    # loss
    parser.add_argument("--self-batch-comparison", action="store_true")
    parser.add_argument("--inter-batch-comparison", action="store_true")

    # VINCE
    parser.add_argument("--vince-queue-size", default=256, type=int)
    parser.add_argument("--vince-embedding-size", default=64, type=int)
    parser.add_argument("--vince-momentum", type=float, default=0.999)
    parser.add_argument("--vince-temperature", type=float, default=0.07)
    parser.add_argument("--vince-self-temperature", type=float, default=0.03)
    parser.add_argument("--no-multi-frame", dest="multi_frame", action="store_false")

    # training
    parser.add_argument("--epochs", default=200, type=int)
    parser.add_argument("--lr-decay-type", default="cos", choices=["cos", "step"])
    parser.add_argument("--lr-step-schedule", default=[120, 160], nargs="*", type=int)
    parser.add_argument("-j", "--num-workers", default=min(multiprocessing.cpu_count(), 16), type=int)
    parser.add_argument("-b", "--batch-size", default=256, type=int)
    parser.add_argument("--use-videos", action="store_true")
    parser.add_argument("-e", "--iterations-per-epoch", default=10000, type=int)
    parser.add_argument("--base-lr", default=0.001, type=float)
    # "lars" is the large-batch recipe; pair it with --base-lr ∝ batch / 256
    parser.add_argument("--optimizer", default="sgd", choices=("sgd", "lars"))
    parser.add_argument("--input-width", default=224, type=int)
    parser.add_argument("--input-height", default=224, type=int)
    parser.add_argument("--use-imagenet-weights", action="store_true")
    parser.add_argument("--no-warmup", dest="use_warmup", action="store_false")
    parser.add_argument("--log-frequency", default=10, type=int)
    parser.add_argument("--image-log-frequency", default=1000, type=int)
    parser.add_argument("--no-save", dest="save", action="store_false")
    parser.add_argument("--no-restore", dest="restore", action="store_false")
    parser.add_argument("--save-frequency", default=5000, type=int)
    parser.add_argument("--long-save-frequency", default=25, type=int)
    parser.add_argument("--disable-dataloader", action="store_true")
    parser.add_argument(
        "--no-batch-prefetch", dest="batch_prefetch", action="store_false",
        help="stage batches in the train loop instead of on the background "
        "staging thread",
    )

    # ImageNet
    parser.add_argument("--use-imagenet", action="store_true")
    parser.add_argument("--imagenet-data-path", type=str, default="")

    # video extraction
    parser.add_argument("--video-sample-rate", default=5, type=int)
    parser.add_argument("--max-video-length", type=int, default=512)
    parser.add_argument("--only-use-shots", action="store_true")
    parser.add_argument("--max-side-size", default=480, type=int)

    # devices
    parser.add_argument(
        "--mesh-data-size", type=int, default=0,
        help="Data-parallel devices (0 = all the processes a queue row leaves); "
        "clamped to the processes of the run.",
    )
    parser.add_argument(
        "--mesh-queue-size", type=int, default=1,
        help="Devices the queue is sharded over (with --distributed; an end task "
        "has no queue and a data axis of every process).",
    )
    parser.add_argument(
        "--pytorch-gpu-ids", type=str, default=None,
        help="The reference's GPU list; its length sets --mesh-data-size when "
        "that is unset.",
    )
    parser.add_argument(
        "--feature-extractor-gpu-ids", type=str, default=None,
        help="As --pytorch-gpu-ids.",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="Multi-process run, one process per GPU: the three flags below, or "
        "torchrun's environment.",
    )
    parser.add_argument("--coordinator-address", type=str, default="",
                        help="host:port of process 0 (with --distributed).")
    parser.add_argument("--num-processes", type=int, default=0,
                        help="Processes in all (with --distributed).")
    parser.add_argument("--process-id", type=int, default=-1,
                        help="This process's id (with --distributed).")
    parser.add_argument(
        "--compute-dtype", default=None, choices=["float32", "bfloat16"],
        help="Encoder compute dtype (default float32, or bfloat16 with --use-apex).",
    )
    parser.add_argument(
        "--use-apex", action="store_true",
        help="The reference's mixed-precision flag: selects bfloat16 compute.",
    )
    parser.add_argument("--no-shuffle-bn", dest="shuffle_bn", action="store_false")
    parser.add_argument(
        "--tracker-slots", type=int, default=8,
        help="Tracking end task: sequences tracked in lockstep.",
    )
    parser.add_argument(
        "--shuffle-mode", type=str, default="gather", choices=["gather", "a2a"],
        help="How shuffled BN scatters the keys over the data axis: 'gather' (the "
        "global batch on every device) or 'a2a' (a balanced all-to-all, 1/d the "
        "traffic; the per-device batch divisible by the data axis).",
    )
    parser.add_argument(
        "--jitter-order", default="torchvision", choices=["torchvision", "fixed"],
        help="ColorJitter: 'torchvision' = a random order of the operators per "
        "sample and exact HSV hue; 'fixed' = b->c->s->hue with a YIQ hue rotation.",
    )
    parser.add_argument(
        "--loader-processes", action="store_true",
        help="Loader workers as a pool of processes instead of threads.",
    )
    parser.add_argument(
        "--stem-kind", default="s2d", choices=["conv7", "s2d"],
        help="ResNet stem: the 7x7-s2 conv in f32, or its space-to-depth form "
        "in the compute dtype (the same parameters).",
    )
    parser.add_argument(
        "--norm-kind", default="batchnorm", choices=["batchnorm", "groupnorm"],
        help="ResNet normalization.",
    )
    parser.add_argument(
        "--bn-fold", default="expand", choices=["none", "expand", "all"],
        help="Fold BatchNorm into the 1x1 products with batch statistics from "
        "the input's moments (the same math and parameters). ResNet: 'expand' "
        "folds conv3 and the downsample, 'all' also conv1. EfficientNet: the "
        "expand convs and the head conv. Nothing to fold under groupnorm.",
    )
    parser.add_argument(
        "--fold-kernel", action="store_true",
        help="Run bn2->relu->conv3 of the folded bottlenecks through the fused "
        "affine->ReLU->1x1 dot + moments kernel.",
    )
    parser.add_argument(
        "--native-decode", action="store_true",
        help="Decode JPEGs on the run's device: nvJPEG and a resize kernel on the GPU, "
             "their plain versions with --platform cpu (not with --loader-processes).",
    )
    parser.add_argument(
        "--dw-kind", default="conv", choices=["conv", "tap", "pallas"],
        help="EfficientNet depthwise convolution: 'conv' = cuDNN's grouped "
        "conv, 'tap' = k^2 shifted multiply-adds, 'pallas' = the port's "
        "depthwise kernel at the stride-1 sites. Ignored by ResNets.",
    )
    parser.add_argument(
        "--se-kind", default="mul", choices=["mul", "fold"],
        help="EfficientNet squeeze-excite: 'mul' = a gate multiply; 'fold' = "
        "the gate folded into the project conv's weights. Ignored by ResNets.",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="Recompute the query encoder's residual blocks (MBConvs) in the "
        "backward instead of keeping their activations: less memory, a second "
        "forward of each block.",
    )
    parser.add_argument(
        "--sync-bn", action="store_true",
        help="BN statistics summed over the data axis, not per device.",
    )
    parser.add_argument(
        "--pretrained-weights-path", type=str, default="",
        help="A reference torch state dict (a VinceModel's or a torchvision "
        "ResNet's) to start both encoders from, loaded if the file exists.",
    )
    parser.add_argument(
        "--cifar-data-path", type=str,
        default=os.path.join("datasets", "cifar_data", "cifar_{data_subset}.npz"),
        help="NPZ path template of the CIFAR kNN probe (skipped if missing).",
    )
    parser.add_argument("--synthetic-num-videos", type=int, default=512)
    parser.add_argument(
        "--use-fused-infonce", action="store_true",
        help="Score the queue with the streamed log-sum-exp kernel; on by "
        "itself for --vince-queue-size > 65536.",
    )
    parser.add_argument(
        "--profile-dir", type=str, default="",
        help="Write a torch.profiler trace of global steps 5-8 into DIR.",
    )
    parser.add_argument(
        "--platform", default="cuda", choices=["cpu", "cuda"],
        help="The device: 'cuda' (the GPU; raises if there is none) or 'cpu'.",
    )
    return parser


def finalize_args(args) -> argparse.Namespace:
    """Derived values and the cross-flag checks."""
    args.input_size = (args.input_height, args.input_width)
    if args.compute_dtype is None:
        # an explicit --compute-dtype wins over --use-apex
        args.compute_dtype = "bfloat16" if getattr(args, "use_apex", False) else "float32"
    gpu_ids = getattr(args, "feature_extractor_gpu_ids", None) or getattr(
        args, "pytorch_gpu_ids", None
    )
    if args.mesh_data_size == 0 and gpu_ids:
        args.mesh_data_size = len(str(gpu_ids).split(","))

    assert (not args.inter_batch_comparison) or (
        args.num_frames % 2 == 0 or args.num_frames == 1
    ), "inter-batch comparison needs an even number of frames (or 1)"
    assert (
        not args.self_batch_comparison
    ) or args.inter_batch_comparison, "self-batch-comparison requires inter-batch-comparison"
    assert args.multi_frame or args.num_frames == 1, "--no-multi-frame needs num_frames == 1"
    assert (
        getattr(args, "jigsaw_sides", "alternate") == "alternate" or args.jigsaw
    ), "--jigsaw-sides requires --jigsaw (it is ignored on the plain path)"
    assert (
        getattr(args, "jigsaw_align_weight", 0.0) == 0.0 or args.jigsaw
    ), "--jigsaw-align-weight requires --jigsaw (it is ignored on the plain path)"
    assert getattr(args, "jigsaw_warmup_steps", 0) == 0 or (
        args.jigsaw and getattr(args, "jigsaw_sides", "alternate") == "alternate"
    ), "--jigsaw-warmup-steps requires --jigsaw with --jigsaw-sides alternate"
    assert not getattr(args, "jigsaw_warmup_mix", False) or (
        getattr(args, "jigsaw_warmup_steps", 0) > 0
    ), "--jigsaw-warmup-mix requires --jigsaw-warmup-steps > 0"

    args.tensorboard_dir = os.path.join(
        args.base_logdir, args.title, args.tensorboard_dir,
        constants.TIME_STR + "_" + args.description,
    )
    if args.checkpoint_dir is None:
        args.checkpoint_dir = os.path.join(
            args.base_logdir, args.title, "checkpoints_" + args.description
        )
    if args.long_save_checkpoint_dir is None:
        args.long_save_checkpoint_dir = os.path.join(
            args.base_logdir, args.title, "long_checkpoints",
            constants.TIME_STR + "_" + args.description,
        )

    args.saved_variable_prefix = args.saved_variable_prefix.split(",")
    args.new_variable_prefix = args.new_variable_prefix.split(",")
    return args


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args = finalize_args(args)
    print("args")
    print("\n".join(f"{k}: {v}" for k, v in sorted(vars(args).items())))
    print("-" * 80)
    return args
