"""Build an R2V2 frame cache from YouTube ids (counterpart of
``vince_tpu/scrape/cache_video_dataset.py``):

    python -m vince_tpu_torch.scrape.cache_video_dataset --csv-path ids.csv \\
        --output-path data/r2v2/train [--num-workers 16] [--only-use-shots]

The first column of the CSV gives the ids. Ids listed in the output's
``failed_video_ids.txt`` or ``no_images_video_ids.txt``, and ids with frames
in a shard directory, are skipped; the rest go through ``VideoCacherDataset``
on a pool of threads (the downloads' parallelism). The run appends its failed
downloads (code 1) and its filtered-out videos (codes 2, 3) to those files.
"""

import argparse
import concurrent.futures
import csv
import os
from typing import List, Set

from vince_tpu_torch.data.video_cacher_dataset import VideoCacherDataset


def _read_id_file(path: str) -> Set[str]:
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def _read_csv_ids(path: str) -> List[str]:
    with open(path) as f:
        return [row[0] for row in csv.reader(f) if row]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cache filtered YouTube frames (R2V2 pipeline)")
    parser.add_argument("--csv-path", required=True, help="CSV of video ids")
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--num-workers", type=int, default=16)
    parser.add_argument("--num-frames-to-cache", type=int, default=4)
    parser.add_argument("--video-sample-rate", type=int, default=5)
    parser.add_argument("--max-video-length", type=int, default=512)
    parser.add_argument("--max-side-size", type=int, default=480)
    parser.add_argument("--only-use-shots", action="store_true")
    parser.add_argument("--filter-using-flow", action="store_true")
    args = parser.parse_args(argv)

    all_ids = _read_csv_ids(args.csv_path)
    failed_path = os.path.join(args.output_path, "failed_video_ids.txt")
    no_images_path = os.path.join(args.output_path, "no_images_video_ids.txt")
    skip = _read_id_file(failed_path) | _read_id_file(no_images_path)
    cached = set()
    if os.path.isdir(args.output_path):
        for shard in os.listdir(args.output_path):
            sd = os.path.join(args.output_path, shard)
            if len(shard) == 2 and os.path.isdir(sd):
                cached.update(name.rsplit("_", 1)[0] for name in os.listdir(sd))
    todo = [v for v in all_ids if v not in skip and v not in cached]
    print(f"{len(todo)} videos to cache ({len(cached)} cached, {len(skip)} known-failed)")

    os.makedirs(args.output_path, exist_ok=True)
    dataset = VideoCacherDataset(args, todo, args.output_path,
                                 filter_using_flow=args.filter_using_flow,
                                 num_frames_to_cache=args.num_frames_to_cache)
    failed, no_images = [], []
    with concurrent.futures.ThreadPoolExecutor(args.num_workers) as pool:
        for vid, code in pool.map(dataset.__getitem__, range(len(dataset))):
            if code == 1:
                failed.append(vid)
            elif code in (2, 3):
                no_images.append(vid)
    with open(failed_path, "a") as f:
        f.writelines(v + "\n" for v in failed)
    with open(no_images_path, "a") as f:
        f.writelines(v + "\n" for v in no_images)
    print(f"done: {len(todo) - len(failed) - len(no_images)} cached, "
          f"{len(failed)} download failures, {len(no_images)} filtered out")
    return failed, no_images


if __name__ == "__main__":
    main()
