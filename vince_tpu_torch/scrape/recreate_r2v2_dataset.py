"""Recreate R2V2 from its published frame indices (counterpart of
``vince_tpu/scrape/recreate_r2v2_dataset.py``):

    python -m vince_tpu_torch.scrape.recreate_r2v2_dataset \\
        --ids-file vince_tpu_torch/info_files/r2v2_ids_val.txt --output-path data/r2v2/val

Each line is ``video_id,f1,f2,f3,f4``. A video whose listed frames all exist
is skipped; otherwise it is downloaded, each listed frame seek-decoded
(``CAP_PROP_POS_FRAMES``, up to 10 tries), scaled to at most
``--max-side-size`` and written as ``<vid[:2]>/<vid>_%06d.jpg``.
"""

import argparse
import concurrent.futures
import os

from vince_tpu_torch.utils import video_utils, youtube_utils

SEEK_TRIES = 10


def recreate_video(line: str, out_dir: str, max_side: int = 480) -> bool:
    """The listed frames of one line's video; True where any was written (or
    all exist)."""
    import cv2

    parts = line.strip().split(",")
    if len(parts) < 2:
        return False
    vid, frame_ids = parts[0], [int(p) for p in parts[1:]]
    im_dir = os.path.join(out_dir, vid[:2])
    if all(os.path.exists(os.path.join(im_dir, f"{vid}_{fi:06d}.jpg")) for fi in frame_ids):
        return True
    video = youtube_utils.download_video(vid)
    if video is None:
        return False
    os.makedirs(im_dir, exist_ok=True)
    cap = cv2.VideoCapture(video)
    ok_any = False
    for fi in frame_ids:
        frame = None
        for _ in range(SEEK_TRIES):
            cap.set(cv2.CAP_PROP_POS_FRAMES, fi)
            ok, frame = cap.read()
            if ok:
                break
        if frame is None:
            continue
        frame = video_utils.max_resize(frame, max_side)
        cv2.imwrite(os.path.join(im_dir, f"{vid}_{fi:06d}.jpg"), frame)
        ok_any = True
    cap.release()
    try:
        os.remove(video)
    except OSError:
        pass
    return ok_any


def main(argv=None):
    parser = argparse.ArgumentParser(description="Recreate R2V2 from frame-index files")
    parser.add_argument("--ids-file", required=True, help="r2v2_ids_{split}.txt")
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--num-workers", type=int, default=16)
    parser.add_argument("--max-side-size", type=int, default=480)
    args = parser.parse_args(argv)

    with open(args.ids_file) as f:
        lines = [line for line in f if line.strip()]
    os.makedirs(args.output_path, exist_ok=True)
    ok = 0
    with concurrent.futures.ThreadPoolExecutor(args.num_workers) as pool:
        for success in pool.map(
                lambda ln: recreate_video(ln, args.output_path, args.max_side_size), lines):
            ok += bool(success)
    print(f"recreated {ok}/{len(lines)} videos")
    return ok


if __name__ == "__main__":
    main()
