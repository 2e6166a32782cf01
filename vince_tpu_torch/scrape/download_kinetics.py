"""Download Kinetics-400 clips into a frame cache (counterpart of
``vince_tpu/scrape/download_kinetics.py``):

    python -m vince_tpu_torch.scrape.download_kinetics \\
        --annotation-json data/kinetics/annotations/train.json --output-path data/kinetics/train

Each annotated video is downloaded and its segment (``annotations.segment``,
by default [0, 10] s) seek-decoded at ``--fps``; the frames, at most
``--max-side-size`` a side, go out as ``<vid[:2]>/<vid>_%06d.jpg``, the layout
``Kinetics400Dataset`` reads.
"""

import argparse
import concurrent.futures
import json
import os

import numpy as np

from vince_tpu_torch.utils import video_utils, youtube_utils


def download_clip(video_id: str, start: float, end: float, out_dir: str, fps: int = 10,
                  max_side: int = 320) -> bool:
    """One clip's frames from ``start`` to ``end`` seconds; True where any was
    written."""
    import cv2

    video = youtube_utils.download_video(video_id)
    if video is None:
        return False
    frames = video_utils.get_frames_by_time(video, np.arange(start, end, 1.0 / fps))
    try:
        os.remove(video)
    except OSError:
        pass
    im_dir = os.path.join(out_dir, video_id[:2])
    os.makedirs(im_dir, exist_ok=True)
    wrote = 0
    for i, frame in enumerate(frames):
        if frame is None:
            continue
        frame = video_utils.max_resize(frame, max_side)
        cv2.imwrite(os.path.join(im_dir, f"{video_id}_{i:06d}.jpg"), frame[:, :, ::-1])
        wrote += 1
    return wrote > 0


def main(argv=None):
    parser = argparse.ArgumentParser(description="Download Kinetics-400 clips → frame cache")
    parser.add_argument("--annotation-json", required=True)
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--num-workers", type=int, default=16)
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--max-side-size", type=int, default=320)
    args = parser.parse_args(argv)

    with open(args.annotation_json) as f:
        annotations = json.load(f)
    jobs = []
    for vid, meta in annotations.items():
        seg = meta.get("annotations", {}).get("segment", [0, 10])
        jobs.append((vid, float(seg[0]), float(seg[1])))
    print(f"{len(jobs)} clips")
    os.makedirs(args.output_path, exist_ok=True)
    ok = 0
    with concurrent.futures.ThreadPoolExecutor(args.num_workers) as pool:
        futures = [pool.submit(download_clip, v, s, e, args.output_path, args.fps,
                               args.max_side_size) for v, s, e in jobs]
        for fut in concurrent.futures.as_completed(futures):
            ok += bool(fut.result())
    print(f"downloaded {ok}/{len(jobs)} clips")
    return ok


if __name__ == "__main__":
    main()
