"""Fetch the released VINCE weights and convert them into a checkpoint
directory of the port (counterpart of
``vince_tpu/scrape/download_pretrained_weights.py``):

    python -m vince_tpu_torch.scrape.download_pretrained_weights --backbone ResNet50 \\
        --output-path pretrained [--skip-convert]

The tar comes from Google Drive through the confirm flow (``drive.drive_fetch``)
and is extracted with ``filter="data"``; its PyTorch checkpoint goes through
``vince_tpu_torch/tools/convert_reference_checkpoint.py`` into
``<output>/checkpoint_<backbone>`` (embeddings 64 for ResNet18, 128 for
ResNet50), for ``--checkpoint-dir``. A failed fetch or a payload that is not
a tar ends the run with a message that says what to fetch by hand.
"""

import argparse
import os
import tarfile

from vince_tpu_torch.scrape import drive

# the published Drive ids of the reference's weights
DRIVE_IDS = {
    "ResNet18": "1L2SZvsvpxe-A1gCN9Nxg9LwB_d604aQf",
    "ResNet50": "11TfKfZLLx2FYCATjkll5nUIOxSgSBWGi",
}
# the released runs' embedding sizes (ResNet50's large run uses MoCo v2's 128)
EMBED_SIZES = {"ResNet18": 64, "ResNet50": 128}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Download released VINCE weights")
    parser.add_argument("--backbone", choices=sorted(DRIVE_IDS), default="ResNet18")
    parser.add_argument("--output-path", default="pretrained")
    parser.add_argument("--skip-convert", action="store_true",
                        help="only download/extract the torch checkpoint")
    args = parser.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    tar_path = os.path.join(args.output_path,
                            f"pretrained_weights_{args.backbone.lower()}.tar")
    file_id = DRIVE_IDS[args.backbone]
    url = f"https://drive.google.com/uc?export=download&id={file_id}"
    try:
        print(f"fetching {args.backbone} weights: {url}")
        drive.drive_fetch(file_id, tar_path)
    except OSError as e:
        raise SystemExit(f"download failed ({e}); offline environment? "
                         f"Fetch the tar manually from {url} and re-run.")
    try:
        with tarfile.open(tar_path) as tf:
            tf.extractall(args.output_path, filter="data")
    except tarfile.ReadError as e:
        raise SystemExit(
            f"{tar_path} is not a tar ({e}) — Drive likely served an "
            f"interstitial page; fetch manually from {url} and re-run.")
    os.remove(tar_path)

    # the conversion writes <step>/state.pt: an earlier run's output is no input
    out = os.path.join(args.output_path, f"checkpoint_{args.backbone.lower()}")
    ckpts = [os.path.join(dp, f) for dp, _, fs in os.walk(args.output_path) for f in fs
             if f.endswith((".pt", ".pth", ".pytorch"))
             and os.path.commonpath([dp, out]) != out]
    if not ckpts:
        raise SystemExit(f"no torch checkpoint found under {args.output_path}")
    print(f"extracted: {ckpts}")
    if args.skip_convert:
        return None
    from vince_tpu_torch.tools.convert_reference_checkpoint import main as convert

    convert(["--torch-checkpoint", ckpts[0], "--output-dir", out,
             "--backbone", args.backbone, "--embed-size", str(EMBED_SIZES[args.backbone])])
    print(f"converted → {out} (use --checkpoint-dir {out})")
    return out


if __name__ == "__main__":
    main()
